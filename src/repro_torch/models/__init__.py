"""Model zoo: the ten architectures as config-driven torch models (the
counterpart of ``repro.models``).

  common       norms, RoPE, initialisation, loss, the parameter tree
  attention    chunked online-softmax GQA attention (+sliding window, KV cache)
  mla          DeepSeek multi-head latent attention (compressed KV cache)
  moe          GShard-style top-k mixture of experts
  transformer  config-driven decoder LM (8 of the 10 archs)
  mamba2       SSD (state-space duality) backbone
  zamba2       hybrid: Mamba2 backbone + shared attention block
  api          build_model(cfg) -> Model(init, forward, prefill, decode, ...)
  convert      weights carried across from and to the reference
"""
from repro_torch.models.api import (LanguageModel, Mamba2LM, Model,
                                    TransformerLM, Zamba2LM, build_model)
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)

__all__ = ["LanguageModel", "Mamba2LM", "Model", "TransformerLM",
           "Zamba2LM", "build_model", "params_from_reference",
           "params_to_reference"]
