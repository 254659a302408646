"""The JAX package's experiment cases (``tests/test_experiments.py``) on
both packages' classes, and the port's grid, split and explorers held to
the reference.

Every case of the subclassed JAX classes runs twice, ``[jax]`` and
``[torch]`` (``tests/torch_package_swap.py``): under ``[torch]`` the
explorer, the grid axes, ``fold_arrays``, ``grid_train_eval`` and
``run_grid_evaluation``, the query service, the controller, the
Recommendation template and the event and storage classes are the
port's; the explorer and the grid run on the CPU because the tests ask
for it (``device="cpu"``; their default is the card).

Beside them:
* the port's ``grid_train_eval``, given the JAX draw as ``init``,
  returns the JAX fold scores exactly (explicit and implicit grids; no
  near-tie at the k-th place, relative 1e-5);
* ``fold_arrays`` and ``grid_axes`` agree between the packages;
* ``pio eval --grid`` of both consoles on one sqlite store ranks the same
  candidate first, the port starting from the JAX draw;
* the two packages' explorers serve heads whose frequencies over 4,000
  queries pass a two-sample chi-square test at p > 0.001 (fixed seeds),
  and epsilon 0.3 explores a share within 4 sigma of 0.3.
"""

import functools
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

import predictionio_tpu.experiments.explore as jax_explore
import predictionio_tpu.experiments.sweep as jax_sweep
import predictionio_tpu_torch.controller as port_controller
import predictionio_tpu_torch.data.aggregator as port_aggregator
import predictionio_tpu_torch.data.event as port_event
import predictionio_tpu_torch.data.storage.base as port_storage_base
import predictionio_tpu_torch.experiments.explore as port_explore
import predictionio_tpu_torch.experiments.sweep as port_sweep
import predictionio_tpu_torch.templates.recommendation as port_recommendation
import predictionio_tpu_torch.templates.recommendation.engine as port_recommendation_engine
import predictionio_tpu_torch.workflow.serving as port_serving
import test_experiments as jax_cases
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage.base import App
from test_experiments import sweep_app  # noqa: F401  (the cases' fixture)
from torch_package_swap import PACKAGES, cpu_context, memory_storage, use_port


def _controller_module() -> types.ModuleType:
    """``predictionio_tpu.controller`` as the port's, ``local_context``
    on the CPU."""
    module = types.ModuleType("predictionio_tpu.controller")
    module.__dict__.update({k: v for k, v in vars(port_controller).items() if not k.startswith("__")})
    module.local_context = cpu_context
    return module


@pytest.fixture(params=PACKAGES)
def package(request, monkeypatch):
    if request.param == "torch":
        use_port(
            monkeypatch,
            jax_cases,
            {
                "ExploreConfig": port_explore.ExploreConfig,
                "Explorer": functools.partial(port_explore.Explorer, device="cpu"),
                "GridAxes": port_sweep.GridAxes,
                "fold_arrays": port_sweep.fold_arrays,
                "grid_axes": port_sweep.grid_axes,
                "grid_train_eval": functools.partial(port_sweep.grid_train_eval, device="cpu"),
                "run_grid_evaluation": port_sweep.run_grid_evaluation,
            },
            {
                "predictionio_tpu.controller": _controller_module(),
                "predictionio_tpu.data.aggregator": port_aggregator,
                "predictionio_tpu.data.event": port_event,
                "predictionio_tpu.data.storage.base": port_storage_base,
                "predictionio_tpu.experiments.explore": port_explore,
                "predictionio_tpu.templates.recommendation": port_recommendation,
                "predictionio_tpu.templates.recommendation.engine": port_recommendation_engine,
                "predictionio_tpu.workflow.serving": port_serving,
            },
        )
    return request.param


@pytest.fixture()
def memory_storage_env(package):
    yield from memory_storage(package)


@pytest.mark.usefixtures("package")
class TestExploreConfig(jax_cases.TestExploreConfig):
    pass


@pytest.mark.usefixtures("package")
class TestEpsilonGreedy(jax_cases.TestEpsilonGreedy):
    pass


@pytest.mark.usefixtures("package")
class TestThompson(jax_cases.TestThompson):
    pass


@pytest.mark.usefixtures("package")
class TestFeedbackAttribution(jax_cases.TestFeedbackAttribution):
    pass


@pytest.mark.usefixtures("package")
class TestGridAxes(jax_cases.TestGridAxes):
    pass


@pytest.mark.usefixtures("package")
class TestGridTrainEval(jax_cases.TestGridTrainEval):
    pass


@pytest.mark.usefixtures("package")
class TestFoldArrays(jax_cases.TestFoldArrays):
    pass


@pytest.mark.usefixtures("package")
class TestRunGridEvaluation(jax_cases.TestRunGridEvaluation):
    pass


def test_cases_run_on_the_ports_classes(package):
    from predictionio_tpu.controller import local_context
    from predictionio_tpu.workflow.serving import QueryService

    prefix = "predictionio_tpu." if package == "jax" else "predictionio_tpu_torch."
    explorer = jax_cases.Explorer(jax_cases.ExploreConfig(policy="epsilon"))
    for obj in (type(explorer), jax_cases.run_grid_evaluation, jax_cases.grid_axes, QueryService):
        assert obj.__module__.startswith(prefix)
    if package == "torch":
        assert explorer.device == torch.device("cpu") and local_context().device == torch.device("cpu")


# ---------------------------------------------------------- grid parity
def jax_draw(seeds, n_users: int, n_items: int, rank: int) -> tuple:
    """The JAX ``grid_train_eval``'s starting factors, drawn as it draws
    them (``fold_in(PRNGKey(0), seed)``, split into users and items)."""
    xs, ys = [], []
    for seed in seeds:
        ku, ki = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), int(seed)))
        xs.append(np.asarray(0.1 * jax.random.normal(ku, (n_users, rank), jnp.float32)))
        ys.append(np.asarray(0.1 * jax.random.normal(ki, (n_items, rank), jnp.float32)))
    return torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ys))


def two_cluster_fold(n: int, seed: int) -> dict:
    """``TestGridTrainEval``'s structured 2-cluster fold at ``n × n``."""
    rng = np.random.default_rng(seed)
    R = np.zeros((n, n), np.float32)
    M = np.zeros((n, n), np.float32)
    T = np.zeros((n, n), np.float32)
    seen = np.zeros((n, n), np.float32)
    for u in range(n):
        for i in range(n):
            if (u % 2) == (i % 2):
                if rng.random() < 0.6:
                    R[u, i], M[u, i], seen[u, i] = 5.0, 1.0, 1.0
                else:
                    T[u, i] = 1.0
            elif rng.random() < 0.4:
                R[u, i], M[u, i], seen[u, i] = 1.0, 1.0, 1.0
    return dict(R=R, M=M, T=T, seen=seen, user_w=np.ones(n, np.float32), item_valid=np.ones(n, np.float32))


GRIDS = {
    # TestGridTrainEval's data and grid, then a wider explicit grid
    "explicit-case": dict(n=16, seed=0, regs=[0.05, 5000.0], alphas=[1.0, 1.0], seeds=[0, 0], rank=4,
                          iterations=8, implicit=False, k=3),
    "explicit": dict(n=24, seed=3, regs=[0.01, 0.1, 1.0, 10.0], alphas=[1.0] * 4, seeds=[0, 1, 2, 3], rank=6,
                     iterations=6, implicit=False, k=4),
    "implicit": dict(n=24, seed=4, regs=[0.01, 0.1, 1.0, 0.1], alphas=[1.0, 1.0, 2.0, 0.5], seeds=[0, 1, 0, 5],
                     rank=6, iterations=6, implicit=True, k=4),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_train_eval_from_the_jax_draw_gives_the_jax_scores(name):
    g = GRIDS[name]
    arrays = two_cluster_fold(g["n"], g["seed"])
    regs, alphas, seeds = np.float32(g["regs"]), np.float32(g["alphas"]), np.int32(g["seeds"])
    statics = dict(rank=g["rank"], iterations=g["iterations"], implicit=g["implicit"], k=g["k"])
    ref = np.asarray(jax_sweep.grid_train_eval(*arrays.values(), regs, alphas, seeds, **statics))
    init = jax_draw(g["seeds"], g["n"], g["n"], g["rank"])
    got = port_sweep.grid_train_eval(*arrays.values(), regs, alphas, seeds, **statics, device="cpu", init=init)
    assert got.shape == (len(g["regs"]),) and got.dtype == torch.float32
    # no near-tie at the k-th place, where a rounding could swap a hit
    # (exact ties, of items with equal rows, break to the lower index in
    # both packages)
    X, Y = port_sweep.grid_train(
        torch.from_numpy(arrays["R"]), torch.from_numpy(arrays["M"]), torch.from_numpy(regs),
        torch.from_numpy(alphas), init[0], init[1], iterations=g["iterations"], implicit=g["implicit"])
    scores = (X @ Y.transpose(1, 2)).double().numpy()
    scores[:, arrays["seen"] > 0] = -np.inf
    top = -np.sort(-scores, axis=2)[:, :, g["k"] - 1:g["k"] + 1]
    finite = np.isfinite(top).all(axis=2)
    gap = np.abs(top[..., 0] - top[..., 1]) / np.maximum(np.abs(top[..., 0]), 1e-30)
    near = (gap > 0) & (gap <= 1e-5) & finite
    assert not near.any(), gap[near]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_initial_factors_are_equal_for_equal_seeds():
    X, Y = port_sweep.initial_factors([3, 1, 3], 16, 8, 4)
    assert X.shape == (3, 16, 4) and Y.shape == (3, 8, 4)
    assert torch.equal(X[0], X[2]) and torch.equal(Y[0], Y[2]) and not torch.equal(X[0], X[1])


def _ep(package: str):
    if package == "jax":
        from predictionio_tpu.controller import EngineParams
        from predictionio_tpu.templates.recommendation import ALSAlgorithmParams, DataSourceParams
    else:
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.templates.recommendation import ALSAlgorithmParams, DataSourceParams
    return EngineParams, ALSAlgorithmParams, DataSourceParams


@pytest.mark.parametrize("implicit", [False, True])
def test_grid_axes_and_fold_arrays_agree_with_the_reference(implicit):
    axes = {}
    for pkg, sweep in (("jax", jax_sweep), ("torch", port_sweep)):
        EngineParams, ALS, DS = _ep(pkg)
        ds = DS(app_name="a", eval_k=3)
        eps = [EngineParams(datasource=ds, algorithms=(("als", ALS(rank=4, num_iterations=3, lambda_=lam, seed=s,
                                                                   implicit_prefs=implicit, alpha=a)),))
               for lam in (0.01, 0.5) for s in (0, 7) for a in (1.0, 2.0)]
        axes[pkg] = sweep.grid_axes(eps)
    assert vars(axes["torch"]) == vars(axes["jax"]) and axes["torch"].candidates == 8
    td = jax_cases._FoldTD(13, 21, [(u, (3 * u + j) % 21, float(1 + (u + j) % 5)) for u in range(13) for j in range(4)])
    qa = [(jax_cases._Q(str(u)), jax_cases._A([f"i{(u + 9) % 21}", "i0"], seen=[f"i{3 * u % 21}"])) for u in range(0, 13, 2)]
    qa.append((jax_cases._Q("ghost"), jax_cases._A(["i1"])))
    ref, ref_n, ref_k = jax_sweep.fold_arrays(td, qa, k=10)
    got, n, k = port_sweep.fold_arrays(td, qa, k=10)
    assert (n, k) == (ref_n, ref_k) == (7, 10) and set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


EVAL_MODULE = """
from {pkg}.controller import EngineParams, Evaluation
from {pkg}.templates.recommendation import ALSAlgorithmParams, DataSourceParams, engine_factory
from {pkg}.templates.recommendation.engine import PrecisionAtK

evaluation = Evaluation(engine=engine_factory(), metric=PrecisionAtK(4))
evaluation.engine_params_list = [
    EngineParams(datasource=DataSourceParams(app_name="grid-app", eval_k=2),
                 algorithms=(("als", ALSAlgorithmParams(rank=4, num_iterations=5, lambda_=lam, seed=s)),))
    for lam in (0.01, 0.1, 1000.0) for s in (0, 1)
]
"""


def test_eval_grid_of_both_consoles_ranks_the_same_candidate_first(tmp_path, monkeypatch):
    import predictionio_tpu.tools.console as jax_console
    import predictionio_tpu_torch.tools.console as port_console
    from predictionio_tpu_torch.data.event import DataMap, Event

    base = tmp_path / "base"
    Storage.configure({"PIO_FS_BASEDIR": str(base)})
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="grid-app"))
        Storage.get_l_events().init(app_id)
        rng = np.random.default_rng(8)
        events = []
        for u in range(40):
            for i in range(24):
                same = (i % 2) == (u % 2)
                if (same and rng.random() < 0.7) or (not same and rng.random() < 0.3):
                    events.append(Event(event="rate", entity_type="user", entity_id=str(u), target_entity_type="item",
                                        target_entity_id=str(i),
                                        properties=DataMap({"rating": float(rng.integers(4, 6) if same else 1)})))
        Storage.get_l_events().insert_batch(events, app_id)
    finally:
        Storage.configure(None)
    for pkg in ("predictionio_tpu", "predictionio_tpu_torch"):
        (tmp_path / f"grid_{pkg}.py").write_text(EVAL_MODULE.format(pkg=pkg))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(port_sweep, "initial_factors", jax_draw)
    results = {}
    for name, console, storage, extra in (("jax", jax_console, JaxStorage, []),
                                          ("torch", port_console, Storage, ["--device", "cpu"])):
        module = "grid_predictionio_tpu" if name == "jax" else "grid_predictionio_tpu_torch"
        out = tmp_path / f"best-{name}.json"
        storage.configure({"PIO_FS_BASEDIR": str(base)})
        try:
            assert console.main(["eval", f"{module}:evaluation", "--grid", "--output-path", str(out), *extra]) == 0
            (instance,) = [i for i in storage.get_meta_data_evaluation_instances().get_all()
                           if i.evaluation_class == f"{module}:evaluation"]
            assert instance.status == "EVALCOMPLETED"
        finally:
            storage.configure(None)
            sys.modules.pop(module, None)
        results[name] = json.loads(out.read_text())
    ref, got = results["jax"], results["torch"]
    assert got["bestIdx"] == ref["bestIdx"] and got["ranking"] == ref["ranking"]
    ref_scores = [s["score"] for s in ref["engineParamsScores"]]
    got_scores = [s["score"] for s in got["engineParamsScores"]]
    np.testing.assert_allclose(got_scores, ref_scores, rtol=0, atol=1e-6)


# ------------------------------------------------- explorers by distribution
QUERIES = 4000


def _two_sample(a: np.ndarray, b: np.ndarray) -> float:
    keep = (a + b) > 0
    return float(chi2_contingency(np.stack([a[keep], b[keep]]))[1])


def test_thompson_heads_match_the_reference_in_distribution():
    """Fixed scores and widths (the pow2 bucket of 8, one -inf pad): the
    head of each sampled order, 4,000 draws a package."""
    scores = np.float32([10.0, 9.8, 9.5, 9.0, 8.5, 8.0, 7.0, -np.inf])
    widths = np.float32([1.0, 1.0, 0.8, 0.8, 1.2, 0.6, 1.0, 0.0])
    key = jax.random.PRNGKey(11)
    ref = np.bincount([int(jax_explore._thompson_rank(jnp.asarray(scores), jnp.asarray(widths), key, c)[0])
                       for c in range(QUERIES)], minlength=8)
    s, w = torch.from_numpy(scores), torch.from_numpy(widths)
    cpu = torch.device("cpu")
    got = np.bincount([int(port_explore._thompson_rank(s, w, port_explore._generator(cpu, 11, c))[0])
                       for c in range(QUERIES)], minlength=8)
    assert ref[7] == got[7] == 0  # padding never leads
    assert got[0] > got[6] > 0
    assert _two_sample(ref, got) > 0.001, (ref, got)


def test_epsilon_heads_and_share_match_the_reference_in_distribution():
    items = [{"item": f"i{j}", "score": 20.0 - j} for j in range(12)]
    heads, shares = {}, {}
    for name, explore in (("jax", jax_explore), ("torch", port_explore)):
        kwargs = {"device": "cpu"} if name == "torch" else {}
        ex = explore.Explorer(explore.ExploreConfig(policy="epsilon", epsilon=0.3, seed=5), **kwargs)
        counts = np.zeros(12, np.int64)
        for _ in range(QUERIES):
            counts[int(ex.rerank(items)[0]["item"][1:])] += 1
        heads[name] = counts
        shares[name] = ex.stats_json()["explored"] / QUERIES
    sigma = (0.3 * 0.7 / QUERIES) ** 0.5
    assert abs(shares["torch"] - 0.3) < 4 * sigma, shares
    assert abs(shares["jax"] - 0.3) < 4 * sigma, shares
    assert _two_sample(heads["jax"], heads["torch"]) > 0.001, heads


def test_same_seed_and_order_replay_the_same_served_orders():
    items = [{"item": f"i{j}", "score": 5.0 - 0.1 * j} for j in range(20)]
    for policy in ("epsilon", "thompson"):
        runs = []
        for _ in range(2):
            ex = port_explore.Explorer(port_explore.ExploreConfig(policy=policy, epsilon=0.5, seed=9), "cpu")
            runs.append([[e["item"] for e in ex.rerank(items)] for _ in range(30)])
        assert runs[0] == runs[1]
        other = port_explore.Explorer(port_explore.ExploreConfig(policy=policy, epsilon=0.5, seed=10), "cpu")
        assert [[e["item"] for e in other.rerank(items)] for _ in range(30)] != runs[0]
