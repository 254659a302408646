"""The JAX package's e2, self-cleaning and admin-server cases
(``tests/test_e2_and_aux.py``, all of them) on both packages' classes.

Every case runs twice, ``[jax]`` and ``[torch]``
(``tests/torch_package_swap.py``): under ``[torch]`` the test module's
e2 learners and ``k_fold_split`` are the port's copies, and the modules
the cases import in their bodies — ``predictionio_tpu.e2``,
``predictionio_tpu.controller.cleaning``, the event, storage and
aggregator modules and ``predictionio_tpu.tools.adminserver`` — are the
port's, on its memory driver.
"""

import pytest

import predictionio_tpu_torch.controller.cleaning as port_cleaning
import predictionio_tpu_torch.data.aggregator as port_aggregator
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage as port_storage
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.e2 as port_e2
import predictionio_tpu_torch.tools.adminserver as port_adminserver
import test_e2_and_aux as jax_cases
from torch_package_swap import PACKAGES, memory_storage, use_port

E2_NAMES = ("BinaryVectorizer", "CategoricalNaiveBayes", "MarkovChain", "k_fold_split")


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {name: getattr(port_e2, name) for name in E2_NAMES},
            {
                "predictionio_tpu.e2": port_e2,
                "predictionio_tpu.controller.cleaning": port_cleaning,
                "predictionio_tpu.data.aggregator": port_aggregator,
                "predictionio_tpu.data.event": port_event,
                "predictionio_tpu.data.storage": port_storage,
                "predictionio_tpu.data.storage.base": port_storage_base,
                "predictionio_tpu.tools.adminserver": port_adminserver,
            },
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestCategoricalNaiveBayes(jax_cases.TestCategoricalNaiveBayes):
    pass


class TestMarkovChain(jax_cases.TestMarkovChain):
    pass


class TestBinaryVectorizer(jax_cases.TestBinaryVectorizer):
    pass


class TestKFold(jax_cases.TestKFold):
    pass


class TestSelfCleaning(jax_cases.TestSelfCleaning):
    pass


class TestAdminServer(jax_cases.TestAdminServer):
    pass


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.controller.cleaning import SelfCleaningDataSource
    from predictionio_tpu.e2 import stratified_k_fold_split
    from predictionio_tpu.tools.adminserver import AdminService

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for obj in (SelfCleaningDataSource, stratified_k_fold_split, AdminService,
                *(getattr(jax_cases, n) for n in E2_NAMES)):
        assert obj.__module__.startswith(prefix), obj
