"""The port's NAS slice against skinjax's: DynamicCNN, the masked supernet,
the population step, the REINFORCE controller, the host-side searchers and
``run_nas``. The same inputs, drawn with numpy from a seed, go through both
packages; weights cross with ``models/weights.py``'s NAS converters.
skinjax's ``PopulationTrainer`` is never run here (its own tests are the
suite's longest file); the port's population is held against its own
candidates trained alone and against skinjax's supernet step."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skinjax.nas import (
    DEFAULT_SEARCH_SPACE,
    GPSearch as JaxGPSearch,
    ReinforceSearch as JaxReinforceSearch,
    SuperNet as JaxSuperNet,
    build_prompt as jax_build_prompt,
    candidate_masks as jax_candidate_masks,
    embed_params as jax_embed_params,
    envelope_of as jax_envelope_of,
    make_dynamic_model as jax_make_dynamic_model,
    run_nas as jax_run_nas,
)
from skinjax.nas.controller import Controller as JaxController
from skinjax.nas.hpo import tune_hyperparameters as jax_tune
from skinjax_torch.data.pipeline import synthetic_source
from skinjax_torch.models.weights import (
    controller_state_dict_from_flax,
    dynamic_state_dict_from_flax,
    load_numpy_state_dict,
    supernet_state_dict_from_flax,
)
from skinjax_torch.nas import (
    GPSearch,
    LLMSearch,
    ReinforceSearch,
    SuperNet,
    build_prompt,
    candidate_masks,
    embed_params,
    envelope_of,
    make_config_validator,
    run_nas,
)
from skinjax_torch.nas import population as pop_mod
from skinjax_torch.nas import search as search_mod
from skinjax_torch.nas.dynamic_model import DynamicCNN
from skinjax_torch.nas.hpo import tune_hyperparameters
from skinjax_torch.nas.population import Population, PopulationTrainer, _config_key
from skinjax_torch.train.kfold import SubsetSource
from skinjax_torch.train.loop import TrainConfig
from tests.xla_compile_cache import xla_cheap_compile  # noqa: F401

# skinjax's supernet test candidates (tests/test_supernet.py): every
# mechanism, kernel 3 inside a 5×5 envelope, one and two layers a block
MAX_POOL = {
    "num_blocks": 3, "initial_filters": 32, "kernel_size": 5,
    "layers_per_block": 2, "use_pooling": True, "common_dim": 64,
    "attention_mecanism": "gfcam", "num_layers_text_fc": 3,
    "neurons_per_layer_size_of_text_fc": 64, "num_layers_fc_module": 2,
    "neurons_per_layer_size_of_fc_module": 64,
}
CANDIDATES = [
    {"num_blocks": 2, "initial_filters": 16, "kernel_size": 3,
     "layers_per_block": 1, "use_pooling": True, "common_dim": 32,
     "attention_mecanism": "concatenation", "num_layers_text_fc": 1,
     "neurons_per_layer_size_of_text_fc": 32, "num_layers_fc_module": 1,
     "neurons_per_layer_size_of_fc_module": 32},
    {"num_blocks": 3, "initial_filters": 32, "kernel_size": 5,
     "layers_per_block": 2, "use_pooling": True, "common_dim": 64,
     "attention_mecanism": "crossattention", "num_layers_text_fc": 2,
     "neurons_per_layer_size_of_text_fc": 64, "num_layers_fc_module": 2,
     "neurons_per_layer_size_of_fc_module": 64},
    {"num_blocks": 1, "initial_filters": 8, "kernel_size": 3,
     "layers_per_block": 2, "use_pooling": True, "common_dim": 16,
     "attention_mecanism": "metablock", "num_layers_text_fc": 1,
     "neurons_per_layer_size_of_text_fc": 16, "num_layers_fc_module": 2,
     "neurons_per_layer_size_of_fc_module": 32},
    {"num_blocks": 2, "initial_filters": 16, "kernel_size": 3,
     "layers_per_block": 1, "use_pooling": True, "common_dim": 64,
     "attention_mecanism": "gfcam", "num_layers_text_fc": 3,
     "neurons_per_layer_size_of_text_fc": 32, "num_layers_fc_module": 1,
     "neurons_per_layer_size_of_fc_module": 64},
]
NO_POOL = dict(CANDIDATES[0], use_pooling=False)
IDS = [c["attention_mecanism"] for c in CANDIDATES]
VOCAB, CLASSES, B, HW = 11, 4, 3, 16
SMALL_SPACE = {
    "num_blocks": [1, 2], "initial_filters": [8, 16], "kernel_size": [3, 5],
    "layers_per_block": [1, 2], "use_pooling": [True, False], "common_dim": [16, 32],
    "attention_mecanism": ["concatenation", "crossattention", "metablock", "gfcam"],
    "num_layers_text_fc": [1, 2], "neurons_per_layer_size_of_text_fc": [16, 32],
    "num_layers_fc_module": [1, 2], "neurons_per_layer_size_of_fc_module": [16, 32],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(batch=B, size=HW, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    md = rng.normal(size=(batch, VOCAB)).astype(np.float32)
    lb = rng.integers(0, CLASSES, batch).astype(np.int32)
    return img, md, lb


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=tol)


def _port_dynamic(config, params):
    model = DynamicCNN(config, num_classes=CLASSES, vocab_size=VOCAB)
    return load_numpy_state_dict(model, dynamic_state_dict_from_flax(params)).eval()


def _draw(model, *args, seed=0):
    """Parameters for a flax model drawn with numpy on its ``eval_shape``
    tree (no compiled init): kernels normal over sqrt(fan-in), scales
    1 + 0.1·normal, biases 0.1·normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_pairs():
    """Per config: skinjax's candidate params, its envelope's supernet params
    (skinjax's embedding of the candidate) and both forwards' outputs,
    each jitted once."""
    img, md, _ = _data()
    out = {}
    for i, (name, config, maxi) in enumerate(
            [*zip(IDS, CANDIDATES, [MAX_POOL] * 4),
             ("nopool", NO_POOL, dict(MAX_POOL, use_pooling=False))]):
        env = jax_envelope_of([config, maxi])
        cand_model = jax_make_dynamic_model(config, num_classes=CLASSES, vocab_size=VOCAB)
        cand = _draw(cand_model, img, md, seed=2 * i)
        sup_model = JaxSuperNet(env, num_classes=CLASSES, vocab_size=VOCAB)
        masks = jax.tree_util.tree_map(jnp.asarray, jax_candidate_masks(config, env))
        sup0 = _draw(sup_model, img, md, masks, seed=2 * i + 1)
        sup = jax_embed_params(cand, sup0, config, env)
        logits, aux = jax.jit(lambda p: cand_model.apply({"params": p}, img, md, capture=True))(cand)
        apply_sup = jax.jit(lambda p, m=masks, sm=sup_model: sm.apply({"params": p}, img, md, m))
        out[name] = dict(config=config, maxi=maxi, cand=cand, sup0=sup0, sup=sup,
                         logits=logits, aux=aux, sup_logits=apply_sup(sup), apply_sup=apply_sup,
                         sup_model=sup_model, masks=masks)
    return out


@pytest.mark.parametrize("name", IDS + ["nopool"])
def test_dynamic_cnn_matches_skinjax(jax_pairs, name):
    p = jax_pairs[name]
    img, md, _ = _data()
    model = _port_dynamic(p["config"], p["cand"])
    with torch.no_grad():
        logits, aux = model(_t(img), _t(md), capture=True)
    _close(logits, p["logits"], 1e-5)
    _close(aux["feature_map"], p["aux"]["feature_map"], 1e-5)
    _close(aux["img_feat"], p["aux"]["img_feat"], 1e-5)


def test_lecun_init_draws_skinjax_initialisers():
    """``lecun_init`` draws flax's initialisers: kernels LeCun normal cut at
    two deviations (``lecun_normal``), the cross attention's projections
    Xavier uniform (skinjax's attention), embeddings normal over their width
    (``Embed``), the LSTM's recurrent weights orthogonal a gate at a time."""
    from skinjax_torch.nas.dynamic_model import make_dynamic_model

    model = make_dynamic_model(CANDIDATES[3], CLASSES, VOCAB, seed=5)
    controller = ReinforceSearch(DEFAULT_SEARCH_SPACE, seed=5, device="cpu").model
    params = {**dict(model.named_parameters()),
              **{f"controller.{n}": p for n, p in controller.named_parameters()}}
    kinds = set()
    for name, p in params.items():
        w = p.detach().double()
        if w.dim() < 2 or name.endswith("start_token"):
            continue
        if "embeds" in name:
            kinds.add("embed")
            assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1) < 0.1, name
        elif "cross" in name:
            kinds.add("xavier")
            bound = (6.0 / (2 * w.shape[1])) ** 0.5
            assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound, name
        elif name.endswith("weight_hh"):
            kinds.add("orthogonal")
            for gate in w.chunk(4):
                np.testing.assert_allclose(gate @ gate.T, np.eye(gate.shape[0]), atol=1e-5)
        else:
            kinds.add("lecun")
            std = w[0].numel() ** -0.5
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7, name
            if w.numel() >= 2000:
                assert abs(float(w.std()) / std - 1) < 0.1, name
    assert kinds == {"embed", "xavier", "orthogonal", "lecun"}


def test_envelopes_and_masks_equal_skinjax():
    groups = [CANDIDATES, [CANDIDATES[0], MAX_POOL], [NO_POOL, dict(MAX_POOL, use_pooling=False)],
              [CANDIDATES[2]]]
    for group in groups:
        env, jenv = envelope_of(group), jax_envelope_of(group)
        assert dataclasses.astuple(env) == dataclasses.astuple(jenv)
        for config in group:
            got, want = candidate_masks(config, env), jax_candidate_masks(config, jenv)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        envelope_of([CANDIDATES[0], NO_POOL])


@pytest.mark.parametrize("name", IDS + ["nopool"])
def test_supernet_matches_dynamic_cnn_and_skinjax(jax_pairs, name):
    """The port's embedding is skinjax's, entry for entry; the port's
    supernet on it matches the port's DynamicCNN and skinjax's supernet
    (skinjax's own tolerance, 2e-5); a bf16 image promotes to float32."""
    p = jax_pairs[name]
    img, md, _ = _data()
    env = envelope_of([p["config"], p["maxi"]])
    port_cand = _port_dynamic(p["config"], p["cand"])
    sup = embed_params(port_cand.state_dict(), supernet_state_dict_from_flax(p["sup0"]),
                       p["config"], env)
    want_sd = supernet_state_dict_from_flax(p["sup"])
    assert sup.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert np.array_equal(sup[k].numpy(), v), k
    model = SuperNet(env, num_classes=CLASSES, vocab_size=VOCAB)
    model.load_state_dict(sup)
    masks = {k: torch.as_tensor(v) for k, v in candidate_masks(p["config"], env).items()}
    with torch.no_grad():
        got = model(_t(img), _t(md), masks)
        want = port_cand(_t(img), _t(md))
        _close(got, want, 2e-5)
        _close(got, p["sup_logits"], 2e-5)
        got16 = model(_t(img).bfloat16(), _t(md), masks)
        assert got16.dtype == torch.float32
        _close(got16, port_cand(_t(img).bfloat16().float(), _t(md)), 2e-5)


def test_two_adam_steps_match_skinjax(jax_pairs):
    """Two Adam steps of the masked supernet against skinjax's two optax
    steps on the same parameters: gradients through every mask and the
    optimizer in one check."""
    p = jax_pairs["crossattention"]
    img, md, lb = _data()
    tx = optax.adam(1e-3)
    sup_model, masks = p["sup_model"], p["masks"]

    @jax.jit
    def step(params, opt):
        def loss_of(q):
            logits = sup_model.apply({"params": q}, img, md, masks)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), lb).mean()

        updates, opt = tx.update(jax.grad(loss_of)(params), opt, params)
        return optax.apply_updates(params, updates), opt

    params, opt = p["sup"], tx.init(p["sup"])
    for _ in range(2):
        params, opt = step(params, opt)
    want = p["apply_sup"](params)
    env = envelope_of([p["config"], p["maxi"]])
    model = SuperNet(env, num_classes=CLASSES, vocab_size=VOCAB)
    load_numpy_state_dict(model, supernet_state_dict_from_flax(p["sup"]))
    tmasks = {k: torch.as_tensor(v) for k, v in candidate_masks(p["config"], env).items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for _ in range(2):
        loss = torch.nn.functional.cross_entropy(model(_t(img), _t(md), tmasks),
                                                 torch.as_tensor(lb, dtype=torch.long))
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        _close(model(_t(img), _t(md), tmasks), want, 5e-5)


def _pop_cfg(**kw):
    return TrainConfig(**{**dict(num_epochs=2, batch_size=8, early_stopping_patience=2,
                                 early_stopping_metric="val_bacc", image_dtype="float32",
                                 device="cpu", learning_rate=1e-3), **kw})


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)),
            _t(rng.normal(size=(n, VOCAB))), torch.as_tensor(rng.integers(0, CLASSES, n)))


def test_population_step_matches_each_candidate_alone():
    """Two vmapped steps of four candidates (augmentation and dropout on)
    against each candidate stepped alone: the same losses and logits, and
    the stacked Adam updates each candidate as its own would."""
    cfg = _pop_cfg(augment=True)
    cw = np.ones(CLASSES, np.float32)
    pop = Population(CANDIDATES, CLASSES, VOCAB, cfg, cw, seed=3, exact_init=True)
    alone = [Population([c], CLASSES, VOCAB, cfg, cw, seed=3, exact_init=True)
             for c in CANDIDATES]
    img, md, lb = _batch()
    for _ in range(2):
        losses = pop.train_step(img, md, lb)
        for k, one in enumerate(alone):
            _close(losses[k], one.train_step(img, md, lb)[0], 1e-5)
    logits = pop.logits(img, md)
    for k, one in enumerate(alone):
        _close(logits[k], one.logits(img, md)[0], 1e-5)


def _trainer_source(seed, n=40):
    src = synthetic_source(n=n, image_size=(HW, HW), feature_dim=VOCAB,
                           num_classes=CLASSES, seed=seed)
    idx = np.arange(len(src))
    cut = n * 4 // 5
    return SubsetSource(src, idx[:cut]), SubsetSource(src, idx[cut:])


def _trainer(seed, **kw):
    tr, va = _trainer_source(seed)
    return PopulationTrainer(tr, va, num_classes=CLASSES, vocab_size=VOCAB,
                             **{"config": _pop_cfg(), **kw})


def test_population_reward_bucket_position_independent():
    """With exact_init (the evaluator's default) a candidate earns the same
    reward at any position, beside any bucket-mates, in any envelope: its
    init and dropout are keyed by its config."""
    target = CANDIDATES[0]
    mates_a = [dict(target, common_dim=16), dict(target, attention_mecanism="crossattention")]
    mates_b = [dict(target, common_dim=16, attention_mecanism="metablock", num_blocks=1)]
    r_first = _trainer(11, exact_init=True).evaluate([target] + mates_a)[0]
    r_last = _trainer(11, exact_init=True).evaluate(mates_b + [target])[-1]
    assert r_first is not None and r_first == pytest.approx(r_last, abs=1e-6)


def test_failed_candidate_isolated_from_bucket_mates(capsys):
    good = CANDIDATES[0]
    bad = dict(good, attention_mecanism="not-a-mechanism")
    rewards = _trainer(7, config=_pop_cfg(num_epochs=1)).evaluate([good, bad, good])
    assert rewards[1] is None
    assert rewards[0] is not None and 0.0 <= rewards[0] <= 1.0
    assert rewards[2] == rewards[0]
    assert "candidate failed alone" in capsys.readouterr().out


def test_population_width_cap_rewards_identical(monkeypatch):
    """A bucket above the device budget trains in chunks of the width that
    fits, with the same rewards; the chunks here share the full bucket's
    envelope (skinjax's construction)."""
    base = dict(CANDIDATES[0])
    A = dict(base, attention_mecanism="concatenation", common_dim=32,
             neurons_per_layer_size_of_text_fc=32, num_layers_text_fc=1,
             num_layers_fc_module=1, neurons_per_layer_size_of_fc_module=32)
    Bc = dict(base, attention_mecanism="gfcam", common_dim=64,
              neurons_per_layer_size_of_text_fc=64, num_layers_text_fc=2,
              num_layers_fc_module=2, neurons_per_layer_size_of_fc_module=64)
    C = dict(base, attention_mecanism="concatenation", common_dim=64,
             neurons_per_layer_size_of_text_fc=32, num_layers_text_fc=2,
             num_layers_fc_module=1, neurons_per_layer_size_of_fc_module=64)
    D = dict(base, attention_mecanism="gfcam", common_dim=32,
             neurons_per_layer_size_of_text_fc=64, num_layers_text_fc=1,
             num_layers_fc_module=2, neurons_per_layer_size_of_fc_module=32)
    group = [A, Bc, C, D]
    env = envelope_of(group)
    assert envelope_of([A, Bc]) == envelope_of([C, D]) == env
    r_full = _trainer(5, exact_init=True).evaluate(group)
    per = pop_mod.population_step_bytes(env, (HW, HW), 8, VOCAB, CLASSES)
    monkeypatch.setattr(pop_mod, "device_budget", lambda device: int(2.5 * per))
    assert pop_mod.hbm_width_cap(env, (HW, HW), 8, int(2.5 * per), VOCAB, CLASSES) == 2
    sizes = []
    real = pop_mod.Population
    monkeypatch.setattr(pop_mod, "Population",
                        lambda configs, *a, **k: sizes.append(len(configs)) or real(configs, *a, **k))
    r_capped = _trainer(5, exact_init=True).evaluate(group)
    assert sizes == [2, 2]
    np.testing.assert_allclose(r_full, r_capped, atol=1e-6)


class _CachingAllocator:
    """The card's memory as PyTorch's caching allocator leaves it: blocks a
    freed population held stay reserved, and ``mem_get_info`` counts them
    as used."""

    def __init__(self, total):
        self.total, self.reserved, self.allocated = total, 0, 0

    def mem_get_info(self, device=None):
        return self.total - self.reserved, self.total

    def memory_reserved(self, device=None):
        return self.reserved

    def memory_allocated(self, device=None):
        return self.allocated


def test_population_budget_survives_the_allocator_cache(monkeypatch):
    """A second bucket gets the width cap of the first: the budget counts
    the blocks the first bucket's freed population left in the cache."""
    import weakref

    base = dict(CANDIDATES[0])
    configs = [dict(base, tag=0), dict(base, tag=1)]  # two buckets of one envelope
    env = envelope_of(configs)
    per = pop_mod.population_step_bytes(env, (HW, HW), 8, VOCAB, CLASSES)
    alloc = _CachingAllocator(int(10.5 * per / pop_mod.MEMORY_SHARE))
    for name in ("mem_get_info", "memory_reserved", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, getattr(alloc, name))
    real_budget, real_population = pop_mod.device_budget, pop_mod.Population
    budgets = []

    def budget(device):
        budgets.append(real_budget(torch.device("cuda", 0)))
        return budgets[-1]

    def population(configs, *a, **k):
        pop = real_population(configs, *a, **k)
        used = len(configs) * per
        alloc.allocated += used
        alloc.reserved = max(alloc.reserved, alloc.allocated)

        def free():
            alloc.allocated -= used

        weakref.finalize(pop, free)
        return pop

    monkeypatch.setattr(pop_mod, "device_budget", budget)
    monkeypatch.setattr(pop_mod, "Population", population)
    rewards = _trainer(2, config=_pop_cfg(num_epochs=1), bucket_keys=("tag",)).evaluate(configs)
    assert all(r is not None for r in rewards)
    assert alloc.reserved == per and alloc.allocated == 0
    assert budgets[0] == budgets[1]
    caps = [pop_mod.hbm_width_cap(env, (HW, HW), 8, b, VOCAB, CLASSES) for b in budgets]
    assert caps == [10, 10]


@pytest.mark.parametrize("layers,pooling", [(1, False), (1, True), (2, False), (2, True)])
def test_population_step_bytes_counts_saved_maps(monkeypatch, layers, pooling):
    """The maps ``population_step_bytes`` reckons a sample are those autograd
    saves in a population step, counted by a saved-tensors hook: the part of
    the saved bytes that grows with the batch, at most a fifth more."""
    configs = [dict(c, layers_per_block=layers, use_pooling=pooling) for c in CANDIDATES[:2]]
    hw = 32

    def saved(batch):
        pop = Population(configs, CLASSES, VOCAB, _pop_cfg(augment=True, batch_size=batch),
                         np.ones(CLASSES, np.float32), seed=0)
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        rng = np.random.default_rng(batch)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            pop.train_step(torch.as_tensor(rng.integers(0, 256, (batch, hw, hw, 3), dtype=np.uint8)),
                           _t(rng.normal(size=(batch, VOCAB))),
                           torch.as_tensor(rng.integers(0, CLASSES, batch)))
        return sum(storages.values()), pop.env

    (s2, env), (s4, _) = saved(2), saved(4)
    monkeypatch.setattr(pop_mod, "TRANSIENT_MAPS", 0)
    est = len(configs) * (pop_mod.population_step_bytes(env, (hw, hw), 4, VOCAB, CLASSES)
                          - pop_mod.population_step_bytes(env, (hw, hw), 2, VOCAB, CLASSES))
    assert s4 - s2 <= est <= 1.2 * (s4 - s2)


def test_population_trainer_refuses_mesh_and_missing_card():
    tr, va = _trainer_source(0)
    with pytest.raises(NotImplementedError):
        PopulationTrainer(tr, va, CLASSES, config=_pop_cfg(), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PopulationTrainer(tr, va, CLASSES, config=_pop_cfg(device="cuda"))


def test_config_key_is_skinjax_crc():
    from skinjax.nas.population import _config_key as jax_key

    for c in CANDIDATES + [MAX_POOL, {"num_blocks": 1, "use_pooling": False}]:
        assert _config_key(c) == jax_key(c)


def test_controller_matches_skinjax(monkeypatch):
    """log-prob and entropy of given indices, then one clipped REINFORCE
    update (the baseline set by a first one), against skinjax's; the
    converted state_dict loads strictly (every key and shape)."""
    space = {k: DEFAULT_SEARCH_SPACE[k] for k in ("num_blocks", "kernel_size", "common_dim")}
    init = JaxController.init  # skinjax inits eagerly, op by op: jitted, one compile
    monkeypatch.setattr(JaxController, "init",
                        lambda self, rng, *a: jax.jit(lambda r, *x: init(self, r, *x))(rng, *a))
    jsearch = JaxReinforceSearch(space, hidden_size=16, grad_clip_norm=0.05, seed=3)
    search = ReinforceSearch(space, hidden_size=16, grad_clip_norm=0.05, seed=3, device="cpu")
    load_numpy_state_dict(search.model, controller_state_dict_from_flax(jsearch.params["params"]))
    rng = np.random.default_rng(0)
    draws = [{k: int(rng.integers(len(v))) for k, v in space.items()} for _ in range(2)]
    for idx in draws:
        want = jsearch.model.apply(jsearch.params, {k: jnp.asarray(v) for k, v in idx.items()})
        got = search.model.score(idx)
        for g, w in zip(got, want):
            _close(g.detach(), w, 1e-5)
    for idx, reward in zip(draws, (0.3, 0.8)):
        want = jsearch.update(idx, reward)
        got = search.update(idx, reward)
        for k in ("loss", "entropy", "baseline"):
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    sd = search.model.state_dict()
    for k, v in controller_state_dict_from_flax(jsearch.params["params"]).items():
        _close(sd[k], v, 1e-5)
    config, indices = search.sample_config()
    assert set(config) == set(space) and all(config[k] == space[k][i] for k, i in indices.items())


def _surrogate(config):
    r = 0.1 + 0.4 * (config["common_dim"] == 32) + 0.4 * (config["attention_mecanism"] == "gfcam")
    return r + 0.01 * config["num_blocks"]


def test_gp_search_and_hpo_match_skinjax():
    """The searchers are numpy: a seed proposes the same configs."""
    for seed in (1, 42):
        a, b = GPSearch(SMALL_SPACE, seed=seed, n_initial=4), JaxGPSearch(SMALL_SPACE, seed=seed,
                                                                          n_initial=4)
        for _ in range(10):
            (ca, ia), (cb, ib) = a.propose(), b.propose()
            assert ca == cb and ia == ib
            a.observe(ia, _surrogate(ca))
            b.observe(ib, _surrogate(cb))
        assert a.best == b.best
    obj = lambda p: p["learning_rate"] * 1e4 + p["text_dropout"]
    for strategy in ("gp", "random"):
        assert tune_hyperparameters(obj, n_trials=10, strategy=strategy) == \
            jax_tune(obj, n_trials=10, strategy=strategy)


def _fake_evaluator(config):
    """Deterministic rewards; a quarter of the configs fail."""
    if config["num_layers_fc_module"] == 2 and config["neurons_per_layer_size_of_fc_module"] == 16:
        return None
    return (_config_key(config) % 997) / 997.0


def _raising(config):
    r = _fake_evaluator(config)
    if r is None:
        raise RuntimeError("failed")
    return r


@pytest.mark.parametrize("strategy,population", [("random", 0), ("bo", 0), ("random", 4)])
def test_run_nas_matches_skinjax(tmp_path, monkeypatch, strategy, population):
    """The step log (rewards, cached and failed marks, memo hits) and
    best_config.json are skinjax's exactly, sequentially and by population."""
    import skinjax.nas.population as jax_pop

    group_sizes = []

    def fake_population(*a, **k):
        def evaluate(configs):
            group_sizes.append(len(configs))
            return [_fake_evaluator(c) for c in configs]
        return evaluate

    monkeypatch.setattr(jax_pop, "make_population_evaluator", fake_population)
    monkeypatch.setattr(pop_mod, "make_population_evaluator", fake_population)
    src = synthetic_source(n=8, image_size=(4, 4), feature_dim=VOCAB, num_classes=CLASSES)
    # eight configs for the population, so that 14 draws repeat some
    space = dict(SMALL_SPACE, **{k: v[:1] for k, v in list(SMALL_SPACE.items())[:-3]}) \
        if population else SMALL_SPACE
    kw = dict(strategy=strategy, search_steps=14, search_space=space, seed=5,
              population_size=population)
    if not population:
        kw["evaluate_candidate"] = _raising
    out = {}
    for name, fn in (("port", run_nas), ("jax", jax_run_nas)):
        out[name] = fn(src, CLASSES, results_dir=str(tmp_path / name),
                       train_cfg=TrainConfig(device="cpu"), **kw)
        out[name] += ((tmp_path / name / "best_config.json").read_text(),)
    assert out["port"] == out["jax"]
    log = out["port"][2]
    assert any(e.get("failed") for e in log)
    if population:
        assert any(e.get("cached") for e in log) and group_sizes
    assert json.loads(out["port"][3])["reward"] == out["port"][1]


def test_llm_search_falls_back_without_server():
    v = make_config_validator(SMALL_SPACE)
    good = {k: c[0] for k, c in SMALL_SPACE.items()}
    assert v(good) == good
    assert v(dict(good, common_dim="16"))["common_dim"] == 16
    assert v(dict(good, attention_mecanism="bogus")) is None
    s = LLMSearch(SMALL_SPACE, model_name="qwen2.5", url="http://127.0.0.1:1/x", max_retries=1)
    cfg = s.propose()
    assert v(cfg) == cfg
    s.observe(cfg, 0.5)
    assert s.best == (cfg, 0.5)
    history = [(cfg, 0.5), (good, 0.25)]
    for mode in ("full", "top"):
        assert build_prompt(SMALL_SPACE, history, mode) == \
            jax_build_prompt(SMALL_SPACE, history, mode)


def test_run_nas_and_retrain_on_the_cpu(tmp_path, monkeypatch):
    """The NAS CLI end to end on the synthetic fixture (a small space, so
    the CPU trains it in seconds): REINFORCE over a population, then the
    sequential BO path with a k-fold retrain; without a card it refuses
    unless asked for the CPU."""
    from skinjax_torch.tools import nas_cli

    space = dict(SMALL_SPACE, num_blocks=[1], initial_filters=[8], layers_per_block=[1],
                 kernel_size=[3], use_pooling=[True])
    monkeypatch.setattr(search_mod, "DEFAULT_SEARCH_SPACE", space)
    common = ["--synthetic", "--epochs", "1", "--batch-size", "16", "--device", "cpu"]
    best, reward, log = nas_cli.main(["--strategy", "reinforce", "--population", "2",
                                      "--steps", "3", "--results-dir", str(tmp_path / "a"),
                                      *common])[:3]
    assert len(log) == 3 and 0.0 <= reward <= 1.0 and set(best) == set(space)
    assert "entropy" in log[0]
    out = nas_cli.main(["--strategy", "bo", "--steps", "1", "--retrain-best",
                        "--results-dir", str(tmp_path / "b"), *common])
    assert len(out[3]) == 5 and all(0.0 <= m["balanced_accuracy"] <= 1.0 for m in out[3])
    assert (tmp_path / "b" / "retrain" / "model_metrics.csv").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            nas_cli.main(["--synthetic", "--steps", "1"])
