from repro_torch.optim.adamw import AdamW, cosine_lr  # noqa: F401
