from eeyore_tpu_torch.utils.itertools import chunk_evenly
