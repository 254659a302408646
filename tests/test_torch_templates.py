"""The JAX package's Similar-Product, E-Commerce and Text-Classification
cases (``tests/test_breadth_templates.py``) on both packages' classes.

Every case runs twice, ``[jax]`` and ``[torch]``
(``tests/torch_package_swap.py``): under ``[torch]`` the test module's
``local_context`` (the CPU, which the tests ask for), ``load_engine_variant``,
``run_train``, ``Event``, ``DataMap`` and ``App`` are the port's, and the
cases' ``from predictionio_tpu.templates.<name> import Query`` reads the
port's template. The engine.json variants name the JAX package's
``engineFactory`` paths, which the port resolves to its own modules of
the same path, so the templates train and serve through the port on the
CPU (rank 8: the Gauss-Jordan solve's plain mirror).
"""

import pytest

import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.templates.ecommerce as port_ecommerce
import predictionio_tpu_torch.templates.similarproduct as port_similarproduct
import predictionio_tpu_torch.templates.textclassification as port_text
import predictionio_tpu_torch.workflow as port_workflow
import test_breadth_templates as jax_cases
from test_breadth_templates import ec_app, sp_app, tx_app  # noqa: F401  (the cases' fixtures)
from torch_package_swap import PACKAGES, cpu_context, memory_storage, use_port


@pytest.fixture(params=PACKAGES, autouse=True)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {
                "local_context": cpu_context,
                "load_engine_variant": port_workflow.load_engine_variant,
                "run_train": port_workflow.run_train,
                "DataMap": port_event.DataMap,
                "Event": port_event.Event,
                "App": port_storage_base.App,
            },
            {
                "predictionio_tpu.templates.similarproduct": port_similarproduct,
                "predictionio_tpu.templates.ecommerce": port_ecommerce,
                "predictionio_tpu.templates.textclassification": port_text,
            },
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


class TestSimilarProduct(jax_cases.TestSimilarProduct):
    pass


class TestECommerce(jax_cases.TestECommerce):
    pass


class TestTextClassification(jax_cases.TestTextClassification):
    pass


def test_cases_run_on_the_ports_classes(package, sp_app):  # noqa: F811
    from predictionio_tpu.templates.similarproduct import Query

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    assert Query.__module__.startswith(prefix)
    assert jax_cases.run_train.__module__.startswith(prefix)
    for variant, name in ((jax_cases.SP_VARIANT, "als"), (jax_cases.EC_VARIANT, "ecomm"), (jax_cases.TX_VARIANT, "nb")):
        engine = jax_cases.load_engine_variant(variant).build_engine()
        assert engine.algorithms_class_map[name].__module__.startswith(prefix)
