"""The port's training step against the reference's for the MoE models
(dbrx; deepseek-v2-lite with MLA and a dense first layer): the checks of
``_model_parity.TrainParity``, the aux loss weighted in."""
import pytest

from _model_parity import (TrainParity, load_arch,  # noqa: F401
                           one_torch_thread)


@pytest.fixture(scope="module", params=["dbrx-132b", "deepseek-v2-lite-16b"])
def arch(request):
    return load_arch(request.param)


class TestTrainParity(TrainParity):
    pass
