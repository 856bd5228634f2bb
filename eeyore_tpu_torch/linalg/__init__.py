from eeyore_tpu_torch.linalg.pd import is_pos_def, nearest_pd
