"""The port's model zoo against the reference's for the dense decoders (qwen2,
codeqwen1.5, qwen1.5) and gemma3's 5:1 sliding-window stack: forward,
prefill and decode logits and caches, cache shapes, the weights carried
across and back, ``state_dict`` keys, decode = forward and checkpoints
across the packages (the checks of ``_model_parity.ArchParity``)."""
import pytest

from _model_parity import ArchParity, load_arch


@pytest.fixture(scope="module", params=["qwen2-0.5b", "codeqwen1.5-7b",
                                              "qwen1.5-4b", "gemma3-12b"])
def arch(request):
    return load_arch(request.param)


class TestArchParity(ArchParity):
    pass
