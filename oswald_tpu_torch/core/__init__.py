from oswald_tpu_torch.core.oracle import (sw_score_numpy, sw_score_diag,
                                          sw_score_diag_batch)

__all__ = ["sw_score_numpy", "sw_score_diag", "sw_score_diag_batch"]
