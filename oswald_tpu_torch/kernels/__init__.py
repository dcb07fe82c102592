from oswald_tpu_torch.kernels.sw_lanes import (sw_groups, sw_groups_ref,
                                               sw_groups_packed,
                                               sw_groups_packed_ref,
                                               sw_lanes_ref)

__all__ = ["sw_groups", "sw_groups_ref", "sw_groups_packed",
           "sw_groups_packed_ref", "sw_lanes_ref"]
