"""The multi-device path: the counterpart of tpufem/dist/ on the
single-controller mesh of ``tpufem_torch.dist.mesh``."""
