from repro_torch.checkpoint import ckpt
