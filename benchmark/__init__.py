"""The benchmark of the port ``sgmcmc_tpu_torch`` (see README.md)."""
