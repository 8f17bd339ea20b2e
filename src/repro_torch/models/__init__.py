"""The LM substrate's models, ported from ``repro.models``: ten
architectures' blocks (dense, GQA/MQA, sliding window, softcap, MoE,
Mamba2, RWKV6, encoder-decoder, VLM stub) as ``nn.Module``s."""

from repro_torch.models import blocks, layers, model, moe, ssm  # noqa: F401
from repro_torch.models.config import (  # noqa: F401
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
)
