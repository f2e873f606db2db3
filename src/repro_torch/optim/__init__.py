from repro_torch.optim.adamw import (OptConfig, OptState, global_norm, init,
                                    lr_at, step, zero_axes, zero_divisor,
                                    zero_gather, zero_slice)
from repro_torch.optim import compress
