"""WireSpec — the single source of truth for the gossip wire format.

ProFe's third pillar (paper Sec. III-D) quantizes everything that
travels — the student and the prototypes — and the wire width is the
headline communication knob: int8 halves and int4 quarters the packed
ring bytes of the int16 default (Sattler et al.'s communication-
efficient federated distillation pushes the same payloads below a byte
per value).  Every layer that serializes, exchanges, or accounts wire
bytes consumes one :class:`WireSpec` instead of a loose ``bits`` int:

* ``kernels/quantize/ops.py`` — packed ``[N, R, 512]`` code buffers are
  encoded to a single contiguous ``[N, B]`` int8 *wire byte buffer*
  (int16/int8 rows bitcast, int4 rows nibble-packed two codes per
  byte), mixed precision segment by segment;
* ``core/round_ops.py`` / ``core/quantization.py`` — the CPU simulator
  quantizes per leaf group with the same per-group bits, bit-identical
  to the mesh codec;
* ``core/mesh_federation.py`` — all exchange modes ship spec-shaped
  buffers, so the ppermute payload physically shrinks to spec bytes;
* ``core/comm.py`` — logical (Table II) and packed-codec byte
  accounting are parametric in the spec and stay asserted byte-exact
  against the compiled HLO (``launch/dryrun.py --bits``).

Leaf *groups* are the top-level keys of the wire payload dict
(``"student"`` — aliased from the accountants' ``"model"`` — and
``"protos"``); ``overrides`` pin any group to an explicit width, which
is how the mixed-precision scenario (int4 student + int16 prototypes)
is expressed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

WIRE_BITS = (4, 8, 16, 32)

# payload-template spelling -> wire-payload spelling: the comm
# accountants call the student leaves "model"
_GROUP_ALIASES = {"model": "student", "": "student"}


def canonical_group(group: Optional[str]) -> str:
    g = group if group is not None else ""
    return _GROUP_ALIASES.get(g, g)


@dataclass(frozen=True)
class WireSpec:
    """Frozen description of the wire format of one gossip payload.

    ``student_bits`` is the default width for every leaf group;
    ``proto_bits`` overrides the ``"protos"`` group (``None`` follows
    the student); ``overrides`` pins arbitrary groups by name.
    ``stochastic_rounding`` replaces the deterministic ``+0.5`` rounding
    with ``+U[0, 1)`` noise (unbiased codes; needs an explicit PRNG key
    at quantize time, and the Pallas fast path falls back to jnp).

    ``error_feedback`` makes the codec *stateful*: each node carries a
    per-leaf residual tree (:class:`repro.core.wire_state.CodecState`)
    that is added to the payload before quantization and updated with
    the fresh quantization error after encoding — the residual never
    leaves the node, so the wire format (and every byte accountant) is
    identical to the stateless spec.  ``ef_decay`` scales the carried
    residual before it re-enters the payload (1.0 = full error
    feedback); quantize calls must thread an explicit ``CodecState``
    (silently dropping the residual would fake the F1 recovery).
    """

    student_bits: int = 16
    proto_bits: Optional[int] = None
    overrides: Tuple[Tuple[str, int], ...] = ()
    stochastic_rounding: bool = False
    error_feedback: bool = False
    ef_decay: float = 1.0

    def __post_init__(self):
        for b in (self.student_bits, self.proto_bits) + tuple(
                b for _, b in self.overrides):
            if b is not None and b not in WIRE_BITS:
                raise ValueError(
                    f"wire bits must be one of {WIRE_BITS}, got {b}")
        if not 0.0 <= self.ef_decay <= 1.0:
            raise ValueError(f"ef_decay must be in [0, 1], "
                             f"got {self.ef_decay}")
        object.__setattr__(self, "overrides", tuple(
            (canonical_group(k), int(b)) for k, b in self.overrides))

    # -- group resolution ---------------------------------------------------
    def bits_for(self, group: Optional[str]) -> int:
        """Wire width of one leaf group (top-level payload key)."""
        g = canonical_group(group)
        for k, b in self.overrides:
            if k == g:
                return b
        if g == "protos" and self.proto_bits is not None:
            return self.proto_bits
        return self.student_bits

    @property
    def uniform_bits(self) -> Optional[int]:
        """The single width when every group shares it, else None."""
        widths = {self.student_bits}
        if self.proto_bits is not None:
            widths.add(self.proto_bits)
        widths.update(b for _, b in self.overrides)
        return self.student_bits if len(widths) == 1 else None

    @property
    def max_bits(self) -> int:
        widths = [self.student_bits]
        if self.proto_bits is not None:
            widths.append(self.proto_bits)
        widths.extend(b for _, b in self.overrides)
        return max(widths)

    def describe(self) -> str:
        u = self.uniform_bits
        if u is not None:
            base = f"int{u}"
        else:
            parts = [f"student=int{self.student_bits}"]
            if self.proto_bits is not None:
                parts.append(f"protos=int{self.proto_bits}")
            parts += [f"{k}=int{b}" for k, b in self.overrides]
            base = ",".join(parts)
        return base + "+ef" if self.error_feedback else base

    def stateless(self) -> "WireSpec":
        """The same wire format without the error-feedback state — what
        the zero-wire-overhead assertions compare against."""
        import dataclasses
        return dataclasses.replace(self, error_feedback=False, ef_decay=1.0)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_bits(cls, bits) -> "WireSpec":
        """Coerce an int (uniform width) or an existing spec."""
        if isinstance(bits, cls):
            return bits
        return cls(student_bits=int(bits))

    @classmethod
    def parse(cls, spec: str) -> "WireSpec":
        """Parse a CLI spec: ``"16"`` | ``"8"`` | ``"4"`` (uniform) or
        ``"<student>/<protos>"`` (mixed, e.g. ``"4/16"`` = int4 student
        + int16 prototypes), optionally followed by comma-separated
        named group overrides (``"4/16,adapters=8"``,
        ``"4,adapters=8,grams=16"``); a ``"+ef"`` suffix (``"4+ef"``,
        ``"4/16,adapters=8+ef"``) enables the stateful error-feedback
        codec.  :meth:`arg` is the inverse: ``parse(spec.arg()) ==
        spec`` for every spec the grammar can express."""
        s = str(spec).strip()
        ef = s.endswith("+ef")
        if ef:
            s = s[:-3]
        base, *named = s.split(",")
        overrides = []
        for part in named:
            if "=" not in part:
                raise ValueError(
                    f"group override must be <group>=<bits>, got {part!r}")
            k, b = part.split("=", 1)
            overrides.append((k.strip(), int(b)))
        if "/" in base:
            student, proto = base.split("/", 1)
            return cls(student_bits=int(student), proto_bits=int(proto),
                       overrides=tuple(overrides), error_feedback=ef)
        return cls(student_bits=int(base), overrides=tuple(overrides),
                   error_feedback=ef)

    def arg(self) -> str:
        """The CLI spelling of this spec (inverse of :meth:`parse`)."""
        base = str(self.student_bits)
        if self.proto_bits is not None:
            base += f"/{self.proto_bits}"
        base += "".join(f",{k}={b}" for k, b in self.overrides)
        return base + "+ef" if self.error_feedback else base


def resolve_spec(bits_or_spec) -> Optional[WireSpec]:
    """None passes through (fp32 wire); ints become uniform specs."""
    if bits_or_spec is None or isinstance(bits_or_spec, WireSpec):
        return bits_or_spec
    return WireSpec.from_bits(bits_or_spec)


def resolve_bits(bits_or_spec, group: str = "student") -> Optional[int]:
    """Scalar width for one group out of an int | WireSpec | None."""
    if bits_or_spec is None:
        return None
    if isinstance(bits_or_spec, WireSpec):
        return bits_or_spec.bits_for(group)
    return int(bits_or_spec)
