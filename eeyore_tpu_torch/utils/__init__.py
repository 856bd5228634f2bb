from eeyore_tpu_torch.utils.dtypes import default_float
from eeyore_tpu_torch.utils.itertools import chunk_evenly
from eeyore_tpu_torch.utils.profiling import PhaseTimer, device_trace, timed
