from mpi4dl_tpu_torch.utils.misc import StepMeter, Timer, get_depth

__all__ = ["StepMeter", "Timer", "get_depth"]
