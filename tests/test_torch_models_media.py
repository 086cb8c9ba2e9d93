"""The port's model zoo against the reference's for the audio-token (musicgen)
and embeddings-input (pixtral) decoders: forward, prefill and decode logits
and caches, cache shapes, the weights carried across and back,
``state_dict`` keys, decode = forward and checkpoints across the packages
(the checks of ``_model_parity.ArchParity``)."""
import pytest

from _model_parity import ArchParity, load_arch


@pytest.fixture(scope="module", params=["musicgen-medium", "pixtral-12b"])
def arch(request):
    return load_arch(request.param)


class TestArchParity(ArchParity):
    pass
