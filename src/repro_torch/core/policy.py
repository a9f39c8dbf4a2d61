"""Quantization policy: which tensors get quantized, how, and on what
backend. Port of `repro/core/policy.py`: flat policies, rules, the
legacy-flag program, the program protocol that calibration overlays, and
the mixed-precision program presets (`olive_mixed_w48`,
`olive_owq_style`) with `get_program` and the CLI's `parse_rules`, and
the baseline presets (`int8`, `int4`, `ant4`: fake-quant through
`core/baselines.py`), and the layer probes (`addresses_layers`) that
tell PTQ whether the reference would keep a program's layer stack
scanned. QAT's `qat` field waits for the code that reads it.

`QuantPolicy` is the per-site decision record. `PolicyProgram` holds
ordered (glob pattern -> QuantPolicy) rules matched case-insensitively
against "/"-joined site addresses (`layers/<i>/attn/wq`,
`layers/<i>/attn/kv`, `lm_head/w_out`, ...); the first match wins.
`QuantPolicy.resolve(site)` goes through the program its legacy flags
compile to (`PolicyProgram.from_policy`). Mixed precision (first/last
layers W8, the rest W4, per-layer kv_bits, per-expert sub-sites
`.../experts/wg/<e>`) is a program: docs/policies.md describes the
grammar, which the port shares.

The port's default backend is `cuda` (hand-written kernels; CPU tensors
take their plain versions), where the reference defaults to `xla`.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    # "none" -> full precision; "olive" -> OVP (the paper);
    # "int" -> uniform int baseline; "ant" -> ANT adaptive-type baseline
    method: str = "none"
    wbits: int = 4                      # 4 or 8
    w_normal_dtype: str = "int4"        # int4 | flint4 | int8
    w_granularity: str = "channel"      # tensor | channel
    abits: int = 0                      # 0 = activations unquantized
    a_normal_dtype: str = "int4"
    act_scale_mode: str = "dynamic"     # dynamic (3σ rule) | static
    static_act_scale: Optional[float] = None
    quantize_attn: bool = True
    quantize_ffn: bool = True
    quantize_embed: bool = False
    quantize_router: bool = False
    kv_bits: int = 0                    # 4 = OVP-packed KV cache
    backend: str = "cuda"               # a `repro_torch.backends` name
    compute_dtype: str = "bfloat16"

    @property
    def enabled(self) -> bool:
        return self.method != "none"

    def normal_dtype_for_bits(self, bits: int) -> str:
        return "int8" if bits == 8 else self.w_normal_dtype

    def resolve(self, site: str) -> "QuantPolicy":
        return _compiled(self).resolve(site)

    def off(self) -> "QuantPolicy":
        return dataclasses.replace(self, method="none")

    def with_backend(self, name: str) -> "QuantPolicy":
        return self if name == self.backend \
            else dataclasses.replace(self, backend=name)

    def replace_all(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)

    def backends(self) -> frozenset:
        return frozenset((self.backend,))

    def as_program(self) -> "PolicyProgram":
        return _compiled(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One pattern -> policy entry; `origin="compat"` marks the legacy
    flag fan compiled by `PolicyProgram.from_policy`."""
    pattern: str
    policy: QuantPolicy
    origin: str = ""

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site.lower(), self.pattern.lower())


def _as_rule(r) -> Rule:
    if isinstance(r, Rule):
        return r
    pattern, policy = r
    return Rule(pattern, policy)


# the sites whose resolution across layers decides the reference's layout
_LAYER_PROBES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "attn/kv",
                 "mlp/wg", "mlp/wu", "mlp/wd", "mlp/wi",
                 "moe/experts/wg", "moe/experts/wd", "moe/router/w_gate",
                 "mlstm/wq", "mlstm/w_up", "rec/wx", "slstm/wz")


@dataclasses.dataclass(frozen=True)
class PolicyProgram:
    """Ordered (pattern -> QuantPolicy) rules + a default; first match
    wins."""
    rules: Tuple[Rule, ...] = ()
    default: QuantPolicy = QuantPolicy()
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "rules",
                           tuple(_as_rule(r) for r in self.rules))

    def resolve(self, site: str) -> QuantPolicy:
        return _program_resolve(self, site)

    # what the model, the engine and quantize_params ask of a policy
    @property
    def enabled(self) -> bool:
        return self.default.enabled or any(r.policy.enabled
                                           for r in self.rules)

    @property
    def compute_dtype(self) -> str:
        return self.default.compute_dtype

    @property
    def backend(self) -> str:
        return self.default.backend

    @property
    def kv_bits(self) -> int:
        """Largest kv_bits any rule can resolve to: nonzero when some
        cache site may be packed (caches resolve kv_bits per layer site)."""
        return max([self.default.kv_bits]
                   + [r.policy.kv_bits for r in self.rules])

    def backends(self) -> frozenset:
        return frozenset([self.default.backend]
                         + [r.policy.backend for r in self.rules])

    def with_backend(self, name: str) -> "PolicyProgram":
        return self.replace_all(backend=name)

    def as_program(self) -> "PolicyProgram":
        return self

    def replace_all(self, **kw) -> "PolicyProgram":
        """`dataclasses.replace` applied to every rule policy and the
        default."""
        return PolicyProgram(
            rules=tuple(Rule(r.pattern, dataclasses.replace(r.policy, **kw),
                             origin=r.origin) for r in self.rules),
            default=dataclasses.replace(self.default, **kw), name=self.name)

    def with_rules(self, rules: Sequence, front: bool = True
                   ) -> "PolicyProgram":
        """A new program with `rules` prepended (they take precedence) or
        appended."""
        extra = tuple(_as_rule(r) for r in rules)
        new = extra + self.rules if front else self.rules + extra
        return PolicyProgram(rules=new, default=self.default, name=self.name)

    # ------------------------------------------------------------- layout
    def varies_across_layers(self, n_layers: int) -> bool:
        """True when any two layers resolve differently at a probe site."""
        if n_layers <= 1:
            return False
        sig0 = tuple(self.resolve(f"layers/0/{s}") for s in _LAYER_PROBES)
        return any(tuple(self.resolve(f"layers/{i}/{s}")
                         for s in _LAYER_PROBES) != sig0
                   for i in range(1, n_layers))

    def addresses_layers(self, n_layers: int) -> bool:
        """Would the reference unroll its layer stack for this program
        (`Model.unrolled`)? True when the program resolves differently
        across layers at a probe site, or when any rule pattern names the
        `layers/` grammar. The port always runs its layers unrolled; PTQ
        asks this to quantize a baseline as the reference's layout does
        (`qlinear.stacks_layers`)."""
        if any("layers/" in r.pattern.lower() for r in self.rules):
            return True
        return self.varies_across_layers(n_layers)

    @classmethod
    def from_policy(cls, policy: QuantPolicy,
                    name: str = "") -> "PolicyProgram":
        """Compile the legacy boolean flags into an equivalent program:
        embed/lm_head first, then router, attention, then FFN substrings,
        with the FFN flag as the default bucket."""
        on, off = policy, policy.off()
        a = on if policy.quantize_attn else off
        f = on if policy.quantize_ffn else off
        e = on if policy.quantize_embed else off
        r = on if policy.quantize_router else off
        rules = tuple(
            Rule(p, pol, origin="compat") for p, pol in (
                ("*embed*", e), ("*lm_head*", e),
                ("*router*", r),
                ("*attn*", a), ("*attention*", a),
                ("*wq*", a), ("*wk*", a), ("*wv*", a),
                ("*wo*", a),
                ("*mlp*", f), ("*ffn*", f), ("*expert*", f),
                ("*wi*", f), ("*wu*", f), ("*wg*", f),
                ("*wd*", f),
            ))
        return cls(rules=rules, default=f, name=name or "compat")


@functools.lru_cache(maxsize=256)
def _compiled(policy: QuantPolicy) -> PolicyProgram:
    return PolicyProgram.from_policy(policy)


@functools.lru_cache(maxsize=65536)
def _program_resolve(program: PolicyProgram, site: str) -> QuantPolicy:
    for rule in program.rules:
        if rule.matches(site):
            return rule.policy
    return program.default


PolicyLike = Union[QuantPolicy, PolicyProgram]


def as_program(policy: PolicyLike) -> PolicyProgram:
    """Normalize either policy form to a PolicyProgram."""
    return policy.as_program()


def resolve(policy: PolicyLike, site: str) -> QuantPolicy:
    """The single resolution entry point consumers call per site."""
    return policy.resolve(site)


FP = QuantPolicy(method="none")
OLIVE_W4A4 = QuantPolicy(method="olive", wbits=4, abits=4)
OLIVE_W4 = QuantPolicy(method="olive", wbits=4, abits=0)
OLIVE_W8A8 = QuantPolicy(method="olive", wbits=8, abits=8,
                         w_normal_dtype="int8", a_normal_dtype="int8")
INT8 = QuantPolicy(method="int", wbits=8, abits=8, w_normal_dtype="int8")
INT4 = QuantPolicy(method="int", wbits=4, abits=4)
ANT4 = QuantPolicy(method="ant", wbits=4, abits=4)
OLIVE_SERVE = dataclasses.replace(OLIVE_W4A4, kv_bits=4)

PRESETS = {"fp": FP, "olive_w4a4": OLIVE_W4A4, "olive_w4": OLIVE_W4,
           "olive_w8a8": OLIVE_W8A8, "int8": INT8, "int4": INT4,
           "ant4": ANT4, "olive_serve": OLIVE_SERVE}


def olive_mixed_w48(n_layers: int) -> PolicyProgram:
    """The first and last layers W8A8, every layer between W4A4: the
    paper's "keep sensitive layers at high precision" per layer."""
    base = PolicyProgram.from_policy(OLIVE_W4A4, name="olive_mixed_w48")
    return base.with_rules([
        ("layers/0/*", OLIVE_W8A8),
        (f"layers/{max(n_layers - 1, 0)}/*", OLIVE_W8A8),
    ])


def olive_owq_style(n_layers: int = 0) -> PolicyProgram:
    """OWQ-style: the attention q/k projections, which feed RoPE and the
    scores, stay W8; the rest runs W4."""
    base = PolicyProgram.from_policy(OLIVE_W4A4, name="olive_owq_style")
    return base.with_rules([
        ("*attn/wq*", OLIVE_W8A8),
        ("*attn/wk*", OLIVE_W8A8),
    ])


PROGRAM_PRESETS = {
    "olive_mixed_w48": olive_mixed_w48,
    "olive_owq_style": olive_owq_style,
}


def get_policy(name: Optional[str]) -> QuantPolicy:
    if name is None:
        return FP
    if name not in PRESETS:
        raise KeyError(f"unknown quant policy {name!r}; "
                       f"options: {sorted(PRESETS)}")
    return PRESETS[name]


def get_program(name: Optional[str], n_layers: int = 0) -> PolicyProgram:
    """The program of any preset name: flat presets compile through
    `from_policy`, program presets take the model's layer count."""
    if name in PROGRAM_PRESETS:
        return PROGRAM_PRESETS[name](n_layers)
    return PolicyProgram.from_policy(get_policy(name), name=name or "fp")


def parse_rules(spec: str) -> List[Rule]:
    """A CLI rule list ``pattern=preset[,pattern=preset...]`` -> rules;
    presets name `PRESETS` entries (``fp`` leaves a site unquantized),
    e.g. ``--policy-rules "layers/0/*=olive_w8a8,*mlp*=olive_w4a4"``."""
    rules = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"bad rule {tok!r}: expected pattern=preset")
        pattern, preset = tok.split("=", 1)
        rules.append(Rule(pattern.strip(), get_policy(preset.strip())))
    return rules
