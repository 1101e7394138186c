"""User examples: ``python -m dladmm_tpu_torch.examples.quickstart`` and
``python -m dladmm_tpu_torch.examples.distributed``."""
