from eeyore_tpu_torch.datasets.xydataset import XYDataset, data_paths, one_hot
from eeyore_tpu_torch.datasets.batches import BatchSchedule, as_schedule
