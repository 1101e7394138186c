from dladmm_tpu_torch.baselines.ladmm import ladmm_run  # noqa: F401
