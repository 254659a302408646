"""The JAX package's Classification cases
(``tests/test_classification_template.py``) on both packages' classes.

Every case runs twice, ``[jax]`` and ``[torch]``
(``tests/torch_package_swap.py``): under ``[torch]`` the test module's
template names (``Accuracy``, ``DataSourceParams``, ``LRParams``,
``NaiveBayesParams``, ``engine_factory``), the controller's
``EngineParams``, ``EngineParamsGenerator``, ``Evaluation`` and
``local_context`` (the CPU, which the tests ask for), the workflow's
``load_engine_variant``, ``run_train`` and ``run_evaluation``, and the
event and storage classes are the port's: Naive Bayes and logistic
regression train, serve and evaluate through the port on the CPU.
"""

import pytest

import predictionio_tpu_torch.controller as port_controller
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.templates.classification as port_classification
import predictionio_tpu_torch.workflow as port_workflow
import test_classification_template as jax_cases
from test_classification_template import cls_app  # noqa: F401  (the cases' fixture)
from torch_package_swap import PACKAGES, cpu_context, memory_storage, use_port

TEMPLATE_NAMES = ("Accuracy", "DataSourceParams", "LRParams", "NaiveBayesParams", "engine_factory")


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {
                **{name: getattr(port_classification, name) for name in TEMPLATE_NAMES},
                "EngineParams": port_controller.EngineParams,
                "EngineParamsGenerator": port_controller.EngineParamsGenerator,
                "Evaluation": port_controller.Evaluation,
                "local_context": cpu_context,
                "load_engine_variant": port_workflow.load_engine_variant,
                "run_evaluation": port_workflow.run_evaluation,
                "run_train": port_workflow.run_train,
                "DataMap": port_event.DataMap,
                "Event": port_event.Event,
                "App": port_storage_base.App,
            },
            {},
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestClassificationEndToEnd(jax_cases.TestClassificationEndToEnd):
    pass


def test_cases_run_on_the_ports_classes(package):
    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    for name in TEMPLATE_NAMES + ("run_evaluation", "Evaluation"):
        assert getattr(jax_cases, name).__module__.startswith(prefix), name
