from repro_torch.data.pipeline import (DataConfig, FileSource, Pipeline,
                                      SyntheticSource, make_source)
