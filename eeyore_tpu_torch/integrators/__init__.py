from eeyore_tpu_torch.integrators.mc import Integrator, MCIntegrator
