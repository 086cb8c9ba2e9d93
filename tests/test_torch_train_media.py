"""The port's training step against the reference's for the audio-token
decoder (musicgen) and the embeddings-input VLM backbone (pixtral, whose
unreached embedding table gets a zero gradient in both packages): the
checks of ``_model_parity.TrainParity``."""
import pytest

from _model_parity import (TrainParity, load_arch,  # noqa: F401
                           one_torch_thread)


@pytest.fixture(scope="module", params=["musicgen-medium", "pixtral-12b"])
def arch(request):
    return load_arch(request.param)


class TestTrainParity(TrainParity):
    pass
