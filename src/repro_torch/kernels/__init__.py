"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(:mod:`repro_torch.kernels.ref`) and the device dispatch
(:mod:`repro_torch.kernels.ops`)."""
