from dladmm_tpu_torch.ops.reference import (  # noqa: F401
    shrink,
    apply_dict,
    apply_B,
    dladmm_layer_step,
    make_layer_step,
    make_cached_step,
    LayerParams,
)
from dladmm_tpu_torch.ops.prox import (  # noqa: F401
    PROX_NAMES,
    get_prox,
    prox_l1,
    prox_nonneg_l1,
    prox_box,
    prox_group_l2,
    make_prox_elastic_net,
)
