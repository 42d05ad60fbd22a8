from repro_torch.utils import metrics
