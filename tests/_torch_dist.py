"""Gloo ranks for the port's sharded tests, on the CPU.

`spawn(world, cases, tmp)` starts `world` processes (the "spawn" start
method: each child imports this module afresh, which is why it imports
torch and the port only, never JAX), joins them into one gloo process
group through a rendezvous file under `tmp` (so pytest-xdist workers
never share a port), and runs every case in each rank, in order. A case
is `(name, function name in this module, keyword arguments)`; each
rank's results come back as {name: value}, or {name: "ERROR: ..."} with
the traceback when the case raised, and {"seconds": {name: wall time}}. A gloo timeout bounds a collective
that a failed rank would leave waiting.
"""
from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

GLOO_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread (import it into a
    test module to apply it there). The suite runs several pytest
    workers at once, and torch's default of one thread a core then
    oversubscribes the cores: each of the many small ops of a CPU serve
    waits for its descheduled threads (a launcher test took 40 s instead
    of 0.7 s beside six busy processes, on 8 cores)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _OtherDevice(torch.Tensor):
    """A CPU tensor that reports a device no kernel wrapper serves."""

    @property
    def device(self):
        return torch.device("xpu")


def on_other_device(t: torch.Tensor) -> torch.Tensor:
    """`t` reporting the "xpu" device: a wrapper given it must raise
    (it serves cpu, cuda and meta only)."""
    return torch.Tensor._make_subclass(_OtherDevice, t)


def spawn(world: int, cases, tmp, timeout: float = 600.0):
    """Run `cases` in `world` gloo ranks; returns one result dict a
    rank. A rank that exits non-zero or outlives `timeout` raises."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = str(tmp)
    init = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank, args=(r, world, init, cases, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited abnormally (rank, code): {bad}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(rank, world, init, cases, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    results = {"seconds": {}}
    for name, fn, kw in cases:
        t0 = time.perf_counter()
        try:
            results[name] = globals()[fn](**kw)
        except Exception:                       # reported by the test
            results[name] = "ERROR: " + traceback.format_exc()
        results["seconds"][name] = time.perf_counter() - t0
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ cases
def _mesh(shape=(1, 2)):
    from repro_torch import backends
    from repro_torch.runtime.elastic import MeshPlan
    return backends.configure_mesh(MeshPlan(tuple(shape), ("data", "model"),
                                            0))


def _policy(**kw):
    from repro_torch.core.policy import QuantPolicy
    base = dict(method="olive", wbits=4, abits=0, compute_dtype="float32",
                backend="cuda_sharded")
    base.update(kw)
    return QuantPolicy(**base)


def _shard_stats():
    from repro_torch import backends
    return backends.dispatch_stats()


def matmul(x, w, policy, site, fill=None, shape=(1, 2)):
    """dispatch(x, w) on cuda_sharded, the weight placed first
    (`local_shard`), or, with site suffix "@whole", left whole (which
    raises); returns (output, dispatch stats, shard mode or None)."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    mesh = _mesh(shape)
    whole = site.endswith("@whole")
    site = site.split("@")[0]
    wl = w if whole else sharded.local_shard(w, site, mesh)
    backends.reset_dispatch_stats()
    y = backends.dispatch(torch.as_tensor(x), wl, _policy(**policy),
                          fill=None if fill is None else torch.as_tensor(
                              fill))
    return (y.numpy(), _shard_stats(), getattr(wl, "mode", None))


def decline(x, w, policy, site, shape=(1, 2), mesh=True):
    """The sharded backend's decline code for (x, w), w placed at
    `site`."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    if mesh:
        _mesh(shape)
    else:
        backends.configure_mesh(None)
    b = backends.get_backend("cuda_sharded")
    return b.decline_reason(torch.as_tensor(x), sharded.local_shard(w, site),
                            _policy(**policy))


def mixed_experts(x, w, policy, site, shape=(1, 2)):
    """A MixedExpertQuant stack on cuda_sharded, placed (each group held
    as its part), then dispatched (declines whole: the groups gathered
    whole first) -> (output, stats, each group's held and whole expert
    counts)."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    mesh = _mesh(shape)
    placed = sharded.local_shard(w, site, mesh)
    backends.reset_dispatch_stats()
    y = backends.dispatch(torch.as_tensor(x), placed, _policy(**policy))
    return y.numpy(), _shard_stats(), [
        (int(p.data.shape[0]), int(g.data.shape[0]))
        for p, g in zip(placed.groups, w.groups)]


def attn_decline(q, cache, kind, shape=(1, 2)):
    from repro_torch import backends
    _mesh(shape)
    b = backends.get_backend("cuda_sharded")
    cache = {k: torch.as_tensor(v) for k, v in cache.items()}
    fn = b.decode_attn_decline_reason if kind == "decode" \
        else b.prefill_attn_decline_reason
    return fn(torch.as_tensor(q), cache)


def decode(q, cache, pos, whole=False, shape=(1, 2)):
    """Decode attention on cuda_sharded over this rank's part of `cache`
    (or the whole cache, which raises) -> (out, stats)."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    mesh = _mesh(shape)
    cache = {k: torch.as_tensor(v) for k, v in cache.items()}
    if not whole:
        cache = sharded.local_kv_cache(cache, mesh)
    backends.reset_dispatch_stats()
    y = backends.decode_attention(torch.as_tensor(q), cache,
                                  torch.as_tensor(pos),
                                  policy=_policy(kv_bits=4))
    return y.numpy(), _shard_stats()


def prefill(q, cache, positions, whole=False, shape=(1, 2)):
    """Paged cache-write prefill on cuda_sharded over this rank's part
    (or the whole cache, which raises) -> (out, the cache's leaves after
    the call, this rank's first head, stats)."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    mesh = _mesh(shape)
    cache = {k: torch.as_tensor(v).clone() for k, v in cache.items()}
    if not whole:
        cache = sharded.local_kv_cache(cache, mesh)
    part = sharded.cache_part(cache)
    backends.reset_dispatch_stats()
    y, new = backends.prefill_attention(torch.as_tensor(q), cache,
                                        torch.as_tensor(positions),
                                        policy=_policy(kv_bits=4))
    return (y.numpy(), {k: v.numpy() for k, v in new.items()},
            None if part is None else part[0], _shard_stats())


def partial_declined(q, cache, pos, shape=(1, 2)):
    """Decode attention on cuda_sharded over this rank's part of `cache`
    with a q the decode kernels decline (`q`'s tokens > 1): raises,
    since no fallback serves a part of the heads."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    mesh = _mesh(shape)
    cache = sharded.local_kv_cache(
        {k: torch.as_tensor(v) for k, v in cache.items()}, mesh)
    return backends.decode_attention(torch.as_tensor(q), cache,
                                     torch.as_tensor(pos),
                                     policy=_policy(kv_bits=4))


def kv_site_heads(head_dim, n_kv=4, shape=(1, 2)):
    """`make_kv_site` for an fp slab cache of `head_dim` on cuda_sharded
    -> (its K leaf's heads, its part or None)."""
    from repro_torch.backends import sharded
    from repro_torch.models import layers
    _mesh(shape)
    cache = sharded.make_kv_site(
        lambda heads: layers.make_kv_cache(2, 8, heads, head_dim,
                                           device="cpu"),
        n_kv, "cuda_sharded")
    return int(cache["k"].shape[2]), sharded.cache_part(cache)


def engine(cfg, tree, policy, requests, engine_kw, shape=(1, 2)):
    """Serve `requests` [(prompt, max new tokens)] on a ServingEngine
    over cuda_sharded, the mesh's plan in its EngineCfg; the weights are
    a reference tree (numpy) converted and placed by
    `convert.params_from_numpy(..., mesh=)` -> (tokens by uid, dispatch
    stats, device_pool_stats, trace_audit, stats)."""
    from repro_torch import backends
    from repro_torch.convert import params_from_numpy as convert
    from repro_torch.models.model import build_model
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    params = convert(tree, device="cpu", mesh=_mesh(shape))
    backends.reset_dispatch_stats()
    eng = ServingEngine(build_model(cfg, _policy(**policy)), params,
                        EngineCfg(backend="cuda_sharded", mesh=MeshPlan(
                            tuple(shape), ("data", "model"), 0),
                            **engine_kw), device="cpu")
    for p, max_new in requests:
        eng.submit(np.asarray(p, np.int32), max_new_tokens=max_new)
    done = eng.run_until_drained()
    return ({r.uid: list(r.out_tokens) for r in done}, _shard_stats(),
            eng.device_pool_stats(), eng.trace_audit(), eng.stats())


def capture_refused(cfg, shape=(1, 2)):
    """ServingEngine(..., capture=True) under a gloo mesh -> its
    ValueError's message."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    model = build_model(cfg, _policy())
    try:
        ServingEngine(model, {}, EngineCfg(
            mesh=MeshPlan(tuple(shape), ("data", "model"), 0)),
            device="cpu", capture=True)
    except ValueError as err:
        return str(err)
    return None


def serve(argv):
    """The launcher's run() at `argv` on the CPU -> its tokens, dispatch
    stats, kernel launches, pool stats and rank."""
    from repro_torch import backends
    from repro_torch.launch import serve as launcher
    backends.configure_mesh(None)
    backends.reset_dispatch_stats()
    launcher.reset_kernel_launches()
    res = launcher.run(argv, device="cpu")
    return {k: res[k] for k in ("outputs", "dispatch", "launches", "pool",
                                "rank")}


def params_from_numpy(tree, shape=(1, 2)):
    """convert.params_from_numpy with the mesh -> the placed tree's
    shard modes and shapes by site, as (mode, data shape, scale shape,
    orig_dim) or the raw tensor's shape."""
    from repro_torch.backends import sharded
    from repro_torch.convert import params_from_numpy as convert
    from repro_torch.core.ovp import QuantizedTensor
    mesh = _mesh(shape)
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        elif isinstance(node, QuantizedTensor):
            out[prefix] = (getattr(node, "mode", None),
                           tuple(node.data.shape), tuple(node.scale.shape),
                           node.orig_dim)
            if isinstance(node, sharded.QuantShard):
                out[prefix + "@data"] = node.data.numpy()
        else:
            out[prefix] = tuple(node.shape)

    walk(convert(tree, device="cpu", mesh=mesh), "")
    return out


def train_policy(quant=None):
    """fp32 compute; with a preset name, that preset under QAT."""
    import dataclasses
    from repro_torch.core.policy import QuantPolicy, get_policy
    if quant is None:
        return QuantPolicy(compute_dtype="float32")
    return dataclasses.replace(get_policy(quant), qat=True,
                               compute_dtype="float32")


def train_sharded(arch, batch, dp_only, steps=3, shape=(1, 2), seed=0,
                  n_microbatches=1, quant=None):
    """`make_sharded_train_step` on a (data, model) mesh of `shape` over
    the port's weights drawn from `seed` on the CPU (`Model.init`, the
    weights `_torch_parity.shared_weights` gives both packages), fp32
    compute, fp32 moments; `quant`, a preset name, trains it with QAT
    (`train_policy`). `dp_only` picks the rules: every axis splits
    the batch (FSDP), or the TP rules (`make_rules` without a global
    batch). Returns the first step's whole-batch loss and gradients
    (gathered whole, as float32 numpy by path), then `steps` steps'
    losses and grad norms, the collectives of the last step, and this
    rank's parameter and moment bytes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.roofline.step_stats import tree_bytes
    from repro_torch.sharding import state as placement
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.train_step import (TrainState,
                                              make_sharded_train_step)
    cfg = get_config(arch)
    model = build_model(cfg, train_policy(quant), remat=True)
    opt = AdamW(lr=1e-3)
    mesh = mesh_lib.make_mesh(tuple(shape), ("data", "model"))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    rows = next(iter(batch.values())).shape[0]
    rules = make_rules(cfg, mesh, global_batch=rows if dp_only else None)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   device="cpu")
    specs = placement.param_specs(params, cfg, mesh, dp_only=dp_only)
    place = placement.Placement(mesh, specs)
    state = place.local(TrainState(params, opt.init(params)))
    step = make_sharded_train_step(model, opt, mesh, specs, rules=rules,
                                   n_microbatches=n_microbatches)
    loss, parts, grads = step.value_and_grad(state.params, batch)
    whole = placement.gather_tree(grads, specs, mesh)
    out = {"loss1": float(loss), "aux1": float(parts["aux"]),
           "grads": {p: g.float().numpy()
                     for p, g in placement.paths(whole)},
           "losses": [], "gnorms": [],
           "param_bytes": tree_bytes(state.params),
           "moment_bytes": tree_bytes(state.opt.mu)
           + tree_bytes(state.opt.nu)}
    for _ in range(steps):
        mesh_lib.reset_collective_stats()
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["gnorms"].append(float(metrics["grad_norm"]))
    out["collectives"] = mesh_lib.collective_stats()
    return out


def train_launcher(argv):
    """The training launcher's run() with `argv` (a --mesh among them)
    on the CPU under the running group -> its history, the held-out
    perplexity, this rank's parameter bytes and the mesh's repr."""
    from repro_torch.launch import train
    from repro_torch.roofline.step_stats import tree_bytes
    res = train.run(argv, device="cpu", log_fn=lambda *a: None)
    return {"history": res["history"], "ppl": res["ppl"],
            "param_bytes": tree_bytes(res["state"].params),
            "mesh": repr(res["mesh"]), "note": res["cell"].note}


def _kv_leaves(caches):
    """{path: tensor} of every K/V leaf of a slab cache tree."""
    from repro_torch.backends.sharded import KV_HEAD_KEYS
    from repro_torch.core.qlinear import tree_paths
    return {p: x for p, x in tree_paths(caches)
            if p.rsplit("/", 1)[-1] in KV_HEAD_KEYS}


def mesh_serve(arch, policy, shape, batch=2, prompt=6, steps=8,
               max_len=16, seed=0):
    """Greedy serving of `arch` at `policy` (QuantPolicy keywords, fp32
    compute) through `Model.forward` (a prefill of `prompt` seeded
    tokens, then `steps` decode steps), on one rank ("cuda", the plain
    versions) and on a (data, model) mesh of `shape` ("cuda_sharded",
    every leaf placed by `place_params`, caches made under the mesh).
    Returns, for "one" and "mesh": the last-token logits of every
    step, the tokens, the K/V leaves (numpy by path), their bytes, each
    KV site's slot part, the dispatch stats, and for "mesh" each
    leaf's held shape beside `local_shape(param_spec)` of its whole
    shape."""
    from repro_torch import backends
    from repro_torch.backends import sharded
    from repro_torch.configs import get_config
    from repro_torch.core.ovp import QuantizedTensor
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.qlinear import quantize_params, tree_paths
    from repro_torch.models.model import build_model
    from repro_torch.sharding import state as placement
    from repro_torch.sharding.rules import mesh_axis_sizes, param_spec
    cfg = get_config(arch)
    toks = torch.randint(0, cfg.vocab, (batch, prompt),
                         generator=torch.Generator().manual_seed(seed + 1))
    out = {}
    for name in ("one", "mesh"):
        mesh = _mesh(shape) if name == "mesh" else \
            backends.configure_mesh(None)
        pol = QuantPolicy(**dict(policy, compute_dtype="float32",
                                 backend="cuda_sharded" if mesh else "cuda"))
        model = build_model(cfg, pol, remat=False)
        whole = {}

        def quant(tree, prefix, mesh=mesh, whole=whole):
            q = quantize_params(tree, pol, prefix=prefix)
            for p, x in tree_paths(q, prefix):
                whole[p] = x
            return q if mesh is None else sharded.place_params(q, prefix,
                                                               mesh)

        params = model.init(torch.Generator().manual_seed(seed),
                            device="cpu", quantize=quant)
        caches = model.init_caches(batch, max_len, device="cpu")
        backends.reset_dispatch_stats()
        logits, caches = model.forward(params, {"tokens": toks},
                                       mode="prefill", caches=caches)
        steps_logits = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        tokens = [tok]
        for i in range(steps):
            pos = torch.full((batch,), prompt + i, dtype=torch.int64)
            logits, caches = model.forward(
                params, {"tokens": tok[:, None], "pos": pos}, mode="decode",
                caches=caches)
            steps_logits.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1], dim=-1)
            tokens.append(tok)
        kv = _kv_leaves(caches)
        res = {"logits": torch.stack(steps_logits).numpy(),
               "tokens": torch.stack(tokens).numpy(),
               "kv": {p: x.numpy() for p, x in kv.items()},
               "kv_bytes": sum(x.numel() * x.element_size()
                               for x in kv.values()),
               "slots": {p: sharded.seq_part(site) for p, site in
                         ((f"layers/{i}/kv", c.get("kv")) for i, c in
                          enumerate(caches["layers"])) if site},
               "stats": backends.dispatch_stats()}
        if mesh is not None:
            sizes = mesh_axis_sizes(mesh)
            held, want, shapes = {}, {}, {}
            for p, x in tree_paths(params):
                w = whole[p]
                shapes[p] = tuple((w.data if isinstance(
                    w, QuantizedTensor) else w).shape)
                if isinstance(w, QuantizedTensor):
                    held[p] = tuple(x.data.shape)
                    want[p] = placement.local_shape(
                        w.data.shape, param_spec(f"{p}/data",
                                                 tuple(w.data.shape), cfg,
                                                 sizes), mesh)
                else:
                    held[p] = tuple(x.shape)
                    want[p] = placement.local_shape(
                        w.shape, param_spec(p, tuple(w.shape), cfg, sizes),
                        mesh)
            res["held"], res["want"], res["whole"] = held, want, shapes
        out[name] = res
        if name == "one":
            one_caches = caches
    if not any(out["mesh"]["slots"].values()):
        return out
    # the partial attention + combine over the last attention site's
    # whole cache from the one-rank run, this rank holding its slots
    sites = [i for i, c in enumerate(one_caches["layers"]) if "kv" in c]
    i = sites[-1]
    window = cfg.window if cfg.block_pattern[i % len(cfg.block_pattern)] \
        == "local_attn" else 0
    whole_cache = one_caches["layers"][i]["kv"]
    ring = window if window and whole_cache[
        "k_data" if "k_data" in whole_cache else "k"].shape[1] == window \
        else 0
    q = torch.randn((batch, 1, cfg.n_heads, cfg.head_dim),
                    generator=torch.Generator().manual_seed(seed + 2))
    pos = torch.tensor([prompt + steps - 1, prompt + steps - 3])[:batch]
    mesh = _mesh(shape)
    part = sharded.local_kv_slots(whole_cache, mesh)
    pol = QuantPolicy(**dict(policy, compute_dtype="float32",
                             backend="cuda_sharded"))
    backends.reset_dispatch_stats()
    att = backends.decode_attention(q, part, pos, policy=pol,
                                    window=window, ring=ring)
    # the KV write into a part of the slots: 3 tokens a row, then 1, on
    # a whole zero cache and on this rank's slots of it
    from repro_torch.models import layers
    zero = {k: torch.zeros_like(v) for k, v in whole_cache.items()}
    mine = sharded.local_kv_slots(zero, mesh)
    gen = torch.Generator().manual_seed(seed + 3)
    kv_shape = (batch, 3, cfg.n_kv_heads, cfg.head_dim)
    for t, at in ((3, torch.tensor([5, 2])), (1, torch.tensor([7, 6]))):
        k_new = torch.randn(kv_shape[:1] + (t,) + kv_shape[2:], generator=gen)
        v_new = torch.randn(k_new.shape, generator=gen)
        for c in (zero, mine):
            layers.cache_write(c, k_new, v_new, at[:batch], pol, ring=ring)
    first, count = sharded.seq_part(mine)[:2]
    out["write"] = {k: (mine[k].numpy(),
                        zero[k][:, first:first + count].numpy())
                    for k in mine if k in sharded.KV_HEAD_KEYS}
    out["attention"] = {"q": q.numpy(), "pos": pos.numpy(),
                        "cache": {k: v.numpy() for k, v in
                                  whole_cache.items()},
                        "window": window, "ring": ring, "out": att.numpy(),
                        "stats": backends.dispatch_stats()}
    return out


def _leaf_bytes(tree, prefix):
    """{path: bytes} of a (placed) params, cache or batch tree; a
    quantized leaf as its "data" and "scale" fields."""
    from repro_torch.core.ovp import QuantizedTensor
    from repro_torch.core.qlinear import tree_paths
    out = {}
    for p, x in tree_paths(tree, prefix):
        if isinstance(x, QuantizedTensor):
            for f in ("data", "scale"):
                t = getattr(x, f)
                out[f"{p}/{f}"] = t.numel() * t.element_size()
        elif isinstance(x, torch.Tensor):
            out[p] = x.numel() * x.element_size()
    return out


def dryrun_cells(cells, world=256, mesh_shape=None, loops_once=True,
                 attn_chunk=None, extra_shapes=None, both=False):
    """Dry-run records of `cells` [(arch, shape, quant, n_microbatches)]
    in this process as rank 0 of a fake group of `world` ranks (the
    production mesh of that size, or a (data, model) mesh of
    `mesh_shape`): each cell's record (`dryrun.run_cell`, its time
    fields dropped) and this rank's bytes by leaf path. `loops_once`
    sets `mesh.LOOPS_ONCE`; `attn_chunk` the prefill attention's block;
    `extra_shapes` {name: (seq, global batch, kind)} registers shapes.
    `both`: {"once": the records with `LOOPS_ONCE` on, "whole": off}."""
    if both:
        kw = dict(cells=cells, world=world, mesh_shape=mesh_shape,
                  attn_chunk=attn_chunk, extra_shapes=extra_shapes)
        return {"once": dryrun_cells(**kw, loops_once=True),
                "whole": dryrun_cells(**kw, loops_once=False)}
    import tempfile
    from repro_torch.configs import base as cbase
    from repro_torch.launch import dryrun, mesh as mesh_lib, specs
    from repro_torch.models import layers
    mesh_lib.LOOPS_ONCE = loops_once
    if attn_chunk:
        layers.ATTN_CHUNK = attn_chunk
    for name, (seq, gb, kind) in (extra_shapes or {}).items():
        cbase.SHAPES[name] = cbase.ShapeCfg(name, seq, gb, kind)
    dryrun.fake_group(world)
    mesh = None if mesh_shape is None else mesh_lib.make_mesh(
        tuple(mesh_shape), ("data", "model"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, quant, nm in cells:
            rec = dryrun.run_cell(arch, shape, "single", quant, tmp,
                                  force=True, mesh_override=mesh,
                                  n_microbatches=nm)
            for k in ("build_s", "trace_s"):
                rec.pop(k, None)
            leaves = {}
            if rec["status"] == "ok" and specs.get_shape(shape).kind != \
                    "train":
                m = mesh or mesh_lib.make_production_mesh()
                cell = specs.build_cell(arch, shape, m, quant=quant)
                held = specs.trace_cell(cell)["held"]
                for tag, tree in zip("pcb", held):
                    leaves.update({f"{tag}:{k}": v for k, v in
                                   _leaf_bytes(tree, "").items()})
            out[f"{arch}__{shape}__{quant}"] = {"record": rec,
                                                "leaves": leaves}
    return out
