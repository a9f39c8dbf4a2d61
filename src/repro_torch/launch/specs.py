"""Cells of the multi-rank dry run: the step function of every (arch x
shape x mesh [x quant]) combination, its arguments, and their specs.
Port of `repro/launch/specs.py`, shared by `launch/dryrun.py` and the
training launcher's `--mesh`.

The reference's cell holds `ShapeDtypeStruct` pytrees and
`NamedSharding`s for `jax.jit(...).lower()`. The port's holds the same
arguments as "meta" tensors of their global shapes, and `Spec` trees;
`trace_cell` runs the step once on this rank over the running process
group (a fake one of the production size in the dry run: nothing is
computed on "meta", the collectives move nothing, and every shape and
collective of the step is exercised). A train cell's step is
`train_step.make_sharded_train_step` over `sharding/state.py`'s
placement; a serve cell's params are quantized on "meta" and placed by
`backends/sharded.py::place_params`, the serving path's placement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.step_stats import tree_bytes
from repro_torch.sharding import state as placement
from repro_torch.sharding.rules import (Spec, cache_pspecs, make_rules,
                                        use_dp_only)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    fn: Callable                   # the step: fn(*local args)
    args: Tuple                    # "meta" tensor trees, global shapes
    in_specs: Tuple                # Spec trees (train state: by path)
    out_specs: Any
    mesh: Any
    rules: Dict[str, Any]
    model_flops: float             # global useful FLOPs per step
    n_chips: int
    note: str = ""
    # args -> (this rank's run args, what this rank holds of them: its
    # parts of every tensor, the batch's rows included)
    localize: Optional[Callable[[Tuple], Tuple[Tuple, Tuple]]] = None
    placement: Optional[placement.Placement] = None
    model: Any = None
    donated: Tuple[int, ...] = ()  # args the step updates in place


def microbatches_for(cfg: ArchConfig, shape: ShapeCfg) -> int:
    """Grad-accumulation depth: keep per-microbatch activation memory
    bounded. Static policy, CLI-overridable."""
    if shape.kind != "train":
        return 1
    big = cfg.d_model >= 4096 or cfg.n_layers >= 48 or cfg.n_experts >= 64
    return 8 if big else 4


def serve_policy(quant: str, n_layers: int = 0, calibration=None):
    """Policy (or policy program, for the mixed presets) of one serve
    cell, by the reference's names. `calibration` (a
    `CalibrationArtifact` or a path to one) switches every rule to
    static activation scales and bakes the artifact's scales in."""
    from repro_torch.core.policy import PROGRAM_PRESETS, get_program
    if quant in PROGRAM_PRESETS:
        policy = get_program(quant, n_layers=n_layers) \
            .replace_all(compute_dtype="bfloat16")
    elif quant == "none":
        policy = QuantPolicy(compute_dtype="bfloat16")
    elif quant == "olive":        # paper-faithful W4A4 serving
        policy = QuantPolicy(method="olive", wbits=4, abits=4,
                             compute_dtype="bfloat16")
    elif quant == "olive_kv":     # + the OVP int4 KV cache
        policy = QuantPolicy(method="olive", wbits=4, abits=4, kv_bits=4,
                             compute_dtype="bfloat16")
    elif quant == "olive_w8":
        policy = QuantPolicy(method="olive", wbits=8, abits=8,
                             w_normal_dtype="int8",
                             compute_dtype="bfloat16")
    else:
        raise ValueError(quant)
    if calibration is not None:
        from repro_torch.core.calibration import (CalibrationArtifact,
                                                  apply_calibration)
        if isinstance(calibration, str):
            calibration = CalibrationArtifact.load(calibration)
        policy = apply_calibration(
            policy.replace_all(act_scale_mode="static"), calibration)
    return policy


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_spec(mesh, rules, cfg: ArchConfig, shape: ShapeCfg,
                kind: str):
    """(global "meta" batch, its Specs) of a cell. A serve cell's token
    ids and positions are int32, the reference's; a train cell's int64
    (the loss's targets)."""
    b_rule = rules["batch"]
    gb, s = shape.global_batch, shape.seq_len
    ids = torch.int64 if kind == "train" else torch.int32
    specs: Dict[str, Any] = {}
    args: Dict[str, Any] = {}
    if kind == "decode":
        args["tokens"] = _meta((gb, 1), ids)
        specs["tokens"] = Spec(b_rule, None)
        args["pos"] = _meta((gb,), ids)
        specs["pos"] = Spec(b_rule)
        return args, specs
    args["tokens"] = _meta((gb, s), ids)
    specs["tokens"] = Spec(b_rule, None)
    if kind == "train":
        args["labels"] = _meta((gb, s), torch.int64)
        specs["labels"] = Spec(b_rule, None)
    if cfg.frontend == "vit":
        args["patch_embeds"] = _meta(
            (gb, cfg.n_frontend_tokens, cfg.frontend_dim), torch.bfloat16)
        specs["patch_embeds"] = Spec(b_rule, None, None)
    if cfg.frontend == "audio":
        args["frames"] = _meta((gb, s, cfg.frontend_dim), torch.bfloat16)
        specs["frames"] = Spec(b_rule, None, None)
    return args, specs


def _local_batch(batch, specs, mesh):
    return {k: placement.local_part(v, specs[k], mesh)
            for k, v in batch.items()}


def build_train_cell(arch: str, shape_name: str, mesh, *,
                     n_microbatches: Optional[int] = None,
                     remat: bool = True, model=None,
                     optimizer: Optional[AdamW] = None) -> Cell:
    """The train cell: the reference's model (bf16 compute, no
    quantization, remat) and AdamW (lr 1e-4, bf16 moments), unless the
    launcher passes its own `model` and `optimizer` (its `--quant` QAT
    policy and schedule: the reference's `--mesh` path trains the
    cell's model and drops them). dp_only is decided at the shape's
    global batch and forces one microbatch."""
    from repro_torch.train.train_step import (init_state,
                                              make_sharded_train_step)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind != "train":
        raise ValueError(f"{shape_name} is a {shape.kind} shape")
    dp_only = use_dp_only(cfg, mesh, shape.global_batch)
    rules = make_rules(cfg, mesh, global_batch=shape.global_batch)
    nm = n_microbatches or microbatches_for(cfg, shape)
    if dp_only:
        nm = 1  # one sequence per chip already
    if model is None:
        model = build_model(cfg, QuantPolicy(compute_dtype="bfloat16"),
                            remat=remat)
    opt = optimizer or AdamW(lr=1e-4, moment_dtype=torch.bfloat16)
    state = init_state(model, opt, None, device="meta")
    specs = placement.param_specs(state.params, cfg, mesh, dp_only=dp_only)
    place = placement.Placement(mesh, specs)
    batch, batch_specs = _batch_spec(mesh, rules, cfg, shape, "train")
    step = make_sharded_train_step(model, opt, mesh, specs, rules=rules,
                                   n_microbatches=nm)
    metrics_specs = {"loss": Spec(), "ce": Spec(), "aux": Spec(),
                     "grad_norm": Spec(), "lr": Spec()}
    n_tokens = shape.global_batch * shape.seq_len

    def localize(args):
        st, b = args
        st = place.local(st)
        # the step takes the loader's global batch and cuts its rows
        return (st, b), (st, _local_batch(b, batch_specs, mesh))

    return Cell(
        arch=arch, shape=shape_name, kind="train", fn=step,
        args=(state, batch), in_specs=(specs, batch_specs),
        out_specs=(specs, metrics_specs), mesh=mesh, rules=rules,
        model_flops=6.0 * cfg.active_param_count() * n_tokens,
        n_chips=mesh_size(mesh),
        note=f"microbatches={nm}, remat={remat}, moments=bf16, grads=bf16"
             + (", dp_only(FSDP)" if dp_only else ""),
        localize=localize, placement=place, model=model, donated=(0,))


def build_serve_cell(arch: str, shape_name: str, mesh, *,
                     quant: str = "none", calibration=None) -> Cell:
    """The serve cell: params drawn on "meta", quantized under
    `serve_policy` on the `cuda_sharded` backend, the raw leaves in
    bf16 as the reference draws them (`_bf16`), and placed by
    `place_params` (every leaf as its `param_spec` part, the
    reference's placement), caches made by the model's cache makers
    under the mesh (this rank's KV heads, or its slots where the
    reference's `cache_pspecs` splits them) for this rank's rows, and
    the batch's rows."""
    from repro_torch.backends import sharded
    from repro_torch.core.qlinear import quantize_params
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"{shape_name} is a {shape.kind} shape")
    long_ctx = shape.name == "long_500k"
    rules = make_rules(cfg, mesh, long_context=long_ctx)
    policy = serve_policy(quant, n_layers=cfg.n_layers,
                          calibration=calibration)
    policy = policy.replace_all(backend="cuda_sharded")
    model = build_model(cfg, policy, remat=False)

    def place(tree, prefix):
        tree = quantize_params(tree, policy, prefix=prefix)
        return sharded.place_params(_bf16(tree), prefix, mesh)

    params = model.init(None, device="meta", quantize=place)
    gb, s = shape.global_batch, shape.seq_len
    enc_len = s if cfg.enc_dec else 0
    batch, batch_specs = _batch_spec(mesh, rules, cfg, shape, shape.kind)
    if cfg.enc_dec and shape.kind == "prefill":
        # an audio enc-dec's prefill feeds frames and tokens
        batch = dict(batch, tokens=_meta((gb, s), torch.int32))
    local_rows = placement.local_shape((gb,), (rules["batch"],), mesh)[0]
    with _serving_mesh(mesh, long_ctx):
        caches = model.init_caches(local_rows, s, enc_len=enc_len,
                                   device="meta", dtype=torch.bfloat16)
    cspecs = cache_pspecs(caches, cfg, mesh, long_context=long_ctx)

    if shape.kind == "prefill":
        def fn(params, caches, batch):
            with _serving_mesh(mesh, long_ctx):
                logits, new = model.forward(params, batch, mode="prefill",
                                            caches=caches)
            return logits[:, -1:], new
        model_flops = 2.0 * cfg.active_param_count() * gb * s
    else:
        def fn(params, caches, batch):
            with _serving_mesh(mesh, long_ctx):
                return model.forward(params, batch, mode="decode",
                                     caches=caches)
        model_flops = 2.0 * cfg.active_param_count() * gb

    def localize(args):
        p, c, b = args
        run = (p, c, _local_batch(b, batch_specs, mesh))
        return run, run

    kv = getattr(policy, "kv_bits", None)
    return Cell(
        arch=arch, shape=shape_name, kind=shape.kind, fn=fn,
        args=(params, caches, batch),
        in_specs=(None, cspecs, batch_specs),
        out_specs=(Spec(rules["batch"], None, rules["vocab"]), cspecs),
        mesh=mesh, rules=rules, model_flops=model_flops,
        n_chips=mesh_size(mesh),
        note=f"quant={quant}, kv_bits={kv}"
             + (", static_act_scales" if calibration is not None else ""),
        localize=localize, model=model, donated=(1,))


F32_LEAVES = ("gamma_scale", "a_param", "fgate_bias", "igate_bias")


def _bf16(tree, key: str = ""):
    """A params tree with its raw floating-point leaves in bf16, as the
    reference draws a serve cell's params, but for the leaves its init
    keeps in f32 (`F32_LEAVES`: the norms' scales, the RG-LRU's decay,
    the xLSTM gates' biases)."""
    if isinstance(tree, dict):
        return {k: _bf16(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point() \
            and key not in F32_LEAVES:
        return tree.to(torch.bfloat16)
    return tree


@contextlib.contextmanager
def _serving_mesh(mesh, long_context: bool = False):
    """The sharded backend's mesh (module state, as its registry is) set
    to `mesh` for the block (a long-context cell's: its caches split
    their slots over the batch axes), then put back."""
    from repro_torch.backends import sharded
    prev = sharded.current_mesh(), sharded.long_context()
    sharded.configure_mesh(mesh, long_context=long_context)
    try:
        yield
    finally:
        sharded.configure_mesh(prev[0], long_context=prev[1])


def build_cell(arch: str, shape_name: str, mesh, *, quant: str = "none",
               calibration=None, n_microbatches: Optional[int] = None
               ) -> Cell:
    shape = get_shape(shape_name)
    if shape.kind == "train":
        return build_train_cell(arch, shape_name, mesh,
                                n_microbatches=n_microbatches)
    return build_serve_cell(arch, shape_name, mesh, quant=quant,
                            calibration=calibration)


def mesh_size(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.size(a)
    return n


def trace_cell(cell: Cell) -> Dict[str, Any]:
    """Run the cell's step once on this rank (the port's `lower_cell`):
    its arguments cut to this rank's parts (`localize`), the collective
    counts reset first. Returns {"arg_bytes", "out_bytes" (this rank's
    argument and output tensors), "alias_bytes" (of the arguments the
    step updates in place: a train state, serving caches), "held" (this
    rank's arguments), "collectives" (`collective_stats()` of the step),
    "trace_s"}."""
    args, held = cell.localize(cell.args) if cell.localize \
        else (cell.args, cell.args)
    arg_bytes = tree_bytes(held)
    mesh_lib.reset_collective_stats()
    t0 = time.perf_counter()
    out = cell.fn(*args)
    trace_s = time.perf_counter() - t0
    return {"arg_bytes": arg_bytes, "out_bytes": tree_bytes(out),
            "alias_bytes": sum(tree_bytes(held[i]) for i in cell.donated),
            "held": held,
            "collectives": mesh_lib.collective_stats(),
            "trace_s": trace_s}
