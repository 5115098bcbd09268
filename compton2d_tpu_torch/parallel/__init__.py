"""Multi-process parallelism over ``torch.distributed``: photon sharding,
rank-ordered tally reductions and the zone farm (counterpart of
``compton2d_tpu.parallel``)."""
