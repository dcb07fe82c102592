from oswald_tpu_torch.utils.metrics import Metrics, gcups

__all__ = ["Metrics", "gcups"]
