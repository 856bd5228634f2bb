from eeyore_tpu_torch.datasets.batches import BatchSchedule, as_schedule
from eeyore_tpu_torch.datasets.counter import DataCounter
from eeyore_tpu_torch.datasets.mld_batcher import MLDBatcher, MLDClassificationBatcher
from eeyore_tpu_torch.datasets.xydataset import (
    EmptyXYDataset,
    IDataset,
    XYDataset,
    XYIDataset,
    data_paths,
    one_hot,
)
