from eeyore_tpu_torch.datasets.xydataset import XYDataset, data_paths, one_hot
