"""The port's configs (the counterpart of ``repro.configs``): the paper's
own FFT workload (``fft_bench``), the ten model-zoo architectures and the
``--arch`` / shape registry."""
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ArchConfig,
                                      MLAConfig, MoEConfig, ShapeSpec,
                                      SSMConfig, shapes_for)
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.deepseek_v2_lite_16b import \
    CONFIG as DEEPSEEK_V2_LITE
from repro_torch.configs.fft_bench import CONFIG, FFTBenchConfig
from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        QWEN2_0_5B, CODEQWEN1_5_7B, QWEN1_5_4B, GEMMA3_12B, MUSICGEN_MEDIUM,
        DBRX_132B, DEEPSEEK_V2_LITE, MAMBA2_370M, PIXTRAL_12B, ZAMBA2_1_2B,
    )
}

SHAPES: dict[str, ShapeSpec] = {s.name: s for s in ALL_SHAPES}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from e


def get_shape(name: str) -> ShapeSpec:
    try:
        return SHAPES[name]
    except KeyError as e:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}") from e


def all_cells() -> list[tuple[ArchConfig, ShapeSpec]]:
    """Every (architecture x applicable shape) dry-run cell."""
    return [(cfg, shp) for cfg in ARCHS.values() for shp in shapes_for(cfg)]


__all__ = [
    "ALL_SHAPES", "ARCHS", "ArchConfig", "CONFIG", "DECODE_32K",
    "FFTBenchConfig", "LONG_500K", "MLAConfig", "MoEConfig", "PREFILL_32K",
    "SHAPES", "SSMConfig", "ShapeSpec", "TRAIN_4K", "all_cells", "get_arch",
    "get_shape", "shapes_for",
]
