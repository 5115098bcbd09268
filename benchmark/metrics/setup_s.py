"""setup_s: seconds from the start of the process to the start of the
window: imports, the kernels' builds or loads, the deployment's tables and
state, the set-up steps and the warm repetition; on several ranks the
slowest rank's, from the parent's start."""


def read(m):
    return m.setup_s
