from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm,
                                          make_optimizer, momentum, sgd)
from repro_torch.optim.schedules import constant, cosine

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "make_optimizer",
           "clip_by_global_norm", "constant", "cosine"]
