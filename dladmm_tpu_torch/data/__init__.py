from dladmm_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticBatch,
    make_dictionary,
    make_batch,
)
