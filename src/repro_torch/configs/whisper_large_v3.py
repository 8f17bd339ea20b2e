"""Whisper-large-v3 — encoder-decoder with conv/mel frontend (stubbed).
[arXiv:2212.04356]

Per the brief, the mel-spectrogram + conv feature extractor is a STUB:
``input_specs`` supplies frame embeddings (B, 1500, d_model) consumed by the
transformer encoder; this module implements encoder + decoder. Whisper uses
LayerNorm + absolute positions + plain-GELU FFN (norm_type/pos_type/ffn_type).

Shape notes (DESIGN.md §7): decode_32k exercises a mechanical 32k-token
decoder self-attention cache (whisper's real decode ceiling is 448 tokens);
long_500k is skipped — full attention, not sub-quadratic."""

from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        arch_type="audio",
        num_layers=32,         # decoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,         # MHA (kv=20)
        head_dim=64,
        d_ff=5120,
        vocab=51_866,
        pattern=("dec_attn",),
        encoder=EncoderConfig(num_layers=32, num_frames=1500, d_model=1280),
        norm_type="layer",
        pos_type="abs",
        ffn_type="gelu",
        frontend="audio_stub",
        param_dtype="float32",
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        arch_type="audio",
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab=512,
        pattern=("dec_attn",),
        encoder=EncoderConfig(num_layers=2, num_frames=64, d_model=256),
        norm_type="layer",
        pos_type="abs",
        ffn_type="gelu",
        frontend="audio_stub",
        remat=False,
        source="arXiv:2212.04356 (reduced)",
    )
