"""histories_per_s: the photons tracked in every step of the window (the
step's n_tracked, summed over the ranks), over the window's seconds."""


def read(m):
    return m.histories / m.window_s
