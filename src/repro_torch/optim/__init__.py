from repro_torch.optim.adamw import (OptConfig, OptState, global_norm, init,
                                    lr_at, step)
