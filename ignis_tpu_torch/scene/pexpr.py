"""PExpr -> torch shading-closure compiler (port of ignis_tpu/scene/pexpr.py).

The reference transpiles PExpr (a SeExpr-like, single-expression, strongly
typed shading language) to Artic source (src/runtime/loader/Transpiler.cpp,
docs/src/scene/pexpr.rst). Here, as in the JAX package, expressions compile
to Python closures; each closure takes a models/texture.ShadeCtx and
returns per-lane tensors, evaluated eagerly on the lanes' device.

Supported: the full operator set (+ - * / % unary- comparisons && || !
select), swizzles (.xyzw / .rgba combinations), implicit int->num
promotion, the documented variable set (uv, uvw, P, Np, N, Ng, Nx, Ny,
V/Rd, Ro, prim_coords, entity_id, Ix, Iy, frontside, Pi, E, Eps, Inf, ...),
scene parameters (read live from ctx.registry when it holds them),
texture variables and calls, and the JAX package's function library.

Values are (type, data): num/int/bool -> a tensor (int values are f32, as
in the JAX package); vecN -> a tuple of N tensors; str -> a python str.
Semantics follow jnp: `%` and `fmod` are floor modulo, `/` divides by
where(y == 0, 1e-20, y), float->int32 conversions saturate (NaN -> 0) as
XLA's do, and the noises reuse models/texture's integer hash.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, NamedTuple, Optional

import torch

from ..core.vec import i32_saturate as _i32
from ..models.texture import ShadeCtx, _hash2, _value_noise


class PExprError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>/\*.*?\*/)
  | (?P<num>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"[^"]*"|'[^']*')
  | (?P<op>\*\*|&&|\|\||==|!=|<=|>=|[-+*/%^<>!?:(),.])
""", re.VERBOSE | re.DOTALL)


class Tok(NamedTuple):
    kind: str
    text: str


def tokenize(src: str) -> List[Tok]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise PExprError(f"PExpr: bad token at '{src[pos:pos+12]}'")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append(Tok(kind, m.group()))
    out.append(Tok("eof", ""))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class Node:
    pass


class Num(Node):
    def __init__(self, v, is_int):
        self.v = v
        self.is_int = is_int


class Str(Node):
    def __init__(self, v):
        self.v = v


class Var(Node):
    def __init__(self, name):
        self.name = name


class Call(Node):
    def __init__(self, name, args):
        self.name = name
        self.args = args


class Unary(Node):
    def __init__(self, op, a):
        self.op = op
        self.a = a


class Binary(Node):
    def __init__(self, op, a, b):
        self.op = op
        self.a = a
        self.b = b


class Ternary(Node):
    def __init__(self, c, a, b):
        self.c = c
        self.a = a
        self.b = b


class Swizzle(Node):
    def __init__(self, a, comps):
        self.a = a
        self.comps = comps


_PREC = {
    "||": 2, "&&": 3,
    "==": 4, "!=": 4, "<": 5, "<=": 5, ">": 5, ">=": 5,
    "+": 6, "-": 6, "*": 7, "/": 7, "%": 7,
    "^": 8, "**": 8,
}


class Parser:
    """Pratt parser; the grammar of ignis_tpu/scene/pexpr.py."""

    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text):
        t = self.next()
        if t.text != text:
            raise PExprError(f"PExpr: expected '{text}', got '{t.text}'")

    def parse(self) -> Node:
        e = self.expr(0)
        if self.peek().kind != "eof":
            raise PExprError(f"PExpr: trailing tokens at '{self.peek().text}'")
        return e

    def expr(self, min_prec) -> Node:
        lhs = self.unary()
        while True:
            t = self.peek()
            if t.text == "?" and min_prec <= 1:
                self.next()
                a = self.expr(0)
                self.expect(":")
                b = self.expr(1)
                lhs = Ternary(lhs, a, b)
                continue
            prec = _PREC.get(t.text)
            if prec is None or prec < min_prec:
                return lhs
            self.next()
            rhs = self.expr(prec + 1)
            lhs = Binary(t.text, lhs, rhs)

    def unary(self) -> Node:
        t = self.peek()
        if t.text in ("-", "+", "!"):
            self.next()
            return Unary(t.text, self.unary())
        return self.postfix()

    def postfix(self) -> Node:
        e = self.primary()
        while self.peek().text == ".":
            self.next()
            t = self.next()
            if t.kind != "name":
                raise PExprError("PExpr: expected swizzle after '.'")
            e = Swizzle(e, t.text)
        return e

    def primary(self) -> Node:
        t = self.next()
        if t.kind == "num":
            txt = t.text
            is_int = re.fullmatch(r"\d+", txt) is not None
            return Num(float(txt), is_int)
        if t.kind == "str":
            return Str(t.text[1:-1])
        if t.kind == "name":
            if self.peek().text == "(":
                self.next()
                args = []
                if self.peek().text != ")":
                    while True:
                        args.append(self.expr(0))
                        if self.peek().text == ",":
                            self.next()
                            continue
                        break
                self.expect(")")
                return Call(t.text, args)
            return Var(t.text)
        if t.text == "(":
            e = self.expr(0)
            self.expect(")")
            return e
        raise PExprError(f"PExpr: unexpected token '{t.text}'")


# ---------------------------------------------------------------------------
# jnp semantics on torch tensors
# ---------------------------------------------------------------------------

VEC_SIZE = {"num": 1, "int": 1, "bool": 1, "vec2": 2, "vec3": 3, "vec4": 4}
_SWIZ_IDX = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3}
_SCALAR = ("num", "int", "bool")


def _full(v, like):
    return torch.full(like.shape, v, dtype=torch.float32, device=like.device)


def _cond(c):
    """A select condition as bool (jnp.where reads nonzero as true)."""
    return c if c.dtype == torch.bool else c != 0


def _f32(v):
    return v if v.dtype == torch.float32 else v.to(torch.float32)


def _mod(x, y):
    """jnp.mod: the C remainder moved to the divisor's sign (y a tensor or
    a python number)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _floor_i32(x):
    return _i32(torch.floor(x))


class Compiler:
    def __init__(self, texture_ids: Dict[str, int],
                 parameters: Optional[Dict[str, tuple]] = None):
        self.texture_ids = texture_ids
        self.parameters = parameters or {}

    def compile(self, src: str):
        """Returns fn(ctx) -> (type, data)."""
        ast = Parser(tokenize(src)).parse()

        def run(ctx: ShadeCtx):
            return self.eval(ast, ctx)
        return run

    def compile_color(self, src: str):
        """Compile expecting a colour output; scalars and vectors cast to
        rgb."""
        f = self.compile(src)

        def run(ctx: ShadeCtx):
            t, v = f(ctx)
            return _to_rgb(t, v)
        return run

    def compile_number(self, src: str):
        f = self.compile(src)

        def run(ctx: ShadeCtx):
            t, v = f(ctx)
            if t in _SCALAR:
                return _f32(v)
            return v[0]
        return run

    # -- core ----------------------------------------------------------------
    def eval(self, n: Node, ctx: ShadeCtx):
        if isinstance(n, Num):
            return ("int" if n.is_int else "num", _full(n.v, ctx.uv[0]))
        if isinstance(n, Str):
            return ("str", n.v)
        if isinstance(n, Var):
            return self.var(n.name, ctx)
        if isinstance(n, Swizzle):
            return self.swizzle(n, ctx)
        if isinstance(n, Unary):
            return self.unary(n, ctx)
        if isinstance(n, Binary):
            return self.binary(n, ctx)
        if isinstance(n, Ternary):
            ct, cv = self.eval(n.c, ctx)
            at, av = self.eval(n.a, ctx)
            bt, bv = self.eval(n.b, ctx)
            at, av, bt, bv = _unify(at, av, bt, bv)
            if at in _SCALAR:
                return (at, torch.where(_cond(cv), av, bv))
            return (at, tuple(torch.where(_cond(cv), x, y)
                              for x, y in zip(av, bv)))
        if isinstance(n, Call):
            return self.call(n, ctx)
        raise PExprError(f"PExpr: unknown node {n}")

    def var(self, name, ctx: ShadeCtx):
        like = ctx.uv[0]
        consts = {
            "Pi": math.pi, "E": math.e, "Eps": 1.19e-7,
            "NumMax": 3.4e38, "NumMin": -3.4e38, "Inf": float("inf"),
        }
        if name in consts:
            return ("num", _full(consts[name], like))
        if name == "true":
            return ("bool", torch.ones(like.shape, dtype=torch.bool,
                                       device=like.device))
        if name == "false":
            return ("bool", torch.zeros(like.shape, dtype=torch.bool,
                                        device=like.device))
        if name == "uv":
            return ("vec2", ctx.uv)
        if name == "prim_coords":
            return ("vec2", ctx.prim_coords)
        if name == "uvw":
            return ("vec3", (ctx.uv[0], ctx.uv[1], torch.zeros_like(like)))
        if name in ("V", "Rd"):
            return ("vec3", ctx.ray_dir)
        if name == "Ro":
            return ("vec3", ctx.ray_org)
        if name == "P":
            return ("vec3", ctx.point)
        if name == "Np":
            return ("vec3", ctx.np_)
        if name == "N":
            return ("vec3", ctx.normal)
        if name == "Ng":
            return ("vec3", ctx.face_normal)
        if name == "Nx":
            return ("vec3", ctx.tangent)
        if name == "Ny":
            return ("vec3", ctx.bitangent)
        if name == "entity_id":
            return ("int", _f32(ctx.entity_id))
        if name == "Ix":
            return ("int", _f32(ctx.pixel[0]))
        if name == "Iy":
            return ("int", _f32(ctx.pixel[1]))
        if name == "frontside":
            return ("bool", ctx.frontside)
        if name in self.parameters:
            t, v = self.parameters[name]
            # the live registry value wins over the load-time constant
            # (reference registry.art: kernels read parameters at run time)
            reg = ctx.registry.get(name) if ctx.registry else None
            if reg is not None:
                if reg.dim() == 0:
                    return ("num", reg.expand(like.shape))
                return (f"vec{reg.shape[0]}",
                        tuple(reg[i].expand(like.shape)
                              for i in range(reg.shape[0])))
            if t == "num":
                return ("num", _full(v, like))
            return (t, tuple(_full(x, like) for x in v))
        if name in self.texture_ids:
            return self._tex_lookup(name, ctx.uv, ctx)
        raise PExprError(f"PExpr: unknown variable '{name}'")

    def _tex_lookup(self, name, uv, ctx: ShadeCtx):
        if ctx.textures is None:
            raise PExprError(f"PExpr: texture '{name}' needs texture context")
        rgb = ctx.textures(self.texture_ids[name], uv)
        return ("vec4", (rgb[0], rgb[1], rgb[2], torch.ones_like(rgb[0])))

    def swizzle(self, n: Swizzle, ctx):
        t, v = self.eval(n.a, ctx)
        comps = (v,) if t in _SCALAR else v
        out = []
        for ch in n.comps:
            if ch not in _SWIZ_IDX:
                raise PExprError(f"PExpr: bad swizzle '{n.comps}'")
            idx = _SWIZ_IDX[ch]
            if idx >= len(comps):
                raise PExprError(f"PExpr: swizzle '{n.comps}' out of range")
            out.append(comps[idx])
        if len(out) == 1:
            return ("num", out[0])
        return (f"vec{len(out)}", tuple(out))

    def unary(self, n: Unary, ctx):
        t, v = self.eval(n.a, ctx)
        if n.op == "!":
            return ("bool", torch.logical_not(v))
        sign = -1.0 if n.op == "-" else 1.0
        if t in ("num", "int"):
            return (t, v * sign)
        return (t, tuple(x * sign for x in v))

    def binary(self, n: Binary, ctx):
        op = n.op
        at, av = self.eval(n.a, ctx)
        bt, bv = self.eval(n.b, ctx)
        if op in ("&&", "||"):
            f = torch.logical_and if op == "&&" else torch.logical_or
            return ("bool", f(av, bv))
        if op in ("==", "!=", "<", "<=", ">", ">="):
            # vectors compare their first component
            fa = av if at in _SCALAR else av[0]
            fb = bv if bt in _SCALAR else bv[0]
            fn = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                  "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op]
            return ("bool", fn(fa, fb))
        at, av, bt, bv = _unify(at, av, bt, bv)
        if op in ("^", "**"):
            f = torch.pow
        else:
            f = {"+": torch.add, "-": torch.sub, "*": torch.mul,
                 "/": lambda x, y: x / torch.where(y == 0, 1e-20, y),
                 "%": _mod}[op]
        if at in ("num", "int"):
            return (at if op != "/" else "num", f(av, bv))
        return (at, tuple(f(x, y) for x, y in zip(av, bv)))

    # -- functions ------------------------------------------------------------
    def call(self, n: Call, ctx):
        name = n.name
        if name in self.texture_ids and name not in _FUNCS1:
            (t, uv) = self.eval(n.args[0], ctx)
            if t == "vec2":
                return self._tex_lookup(name, uv, ctx)
            raise PExprError(f"PExpr: texture call '{name}' expects vec2")
        args = [self.eval(a, ctx) for a in n.args]
        return _call_builtin(name, args, ctx)


def _unify(at, av, bt, bv):
    """Implicit promotion: int->num, scalar->vector broadcast."""
    sa = VEC_SIZE.get(at, 1)
    sb = VEC_SIZE.get(bt, 1)
    if sa == sb:
        t = at if sa > 1 else ("num" if "num" in (at, bt) or at != bt else at)
        return t, av, t, bv
    if sa == 1:
        return bt, tuple(av for _ in range(sb)), bt, bv
    if sb == 1:
        return at, av, at, tuple(bv for _ in range(sa))
    raise PExprError(f"PExpr: cannot combine {at} and {bt}")


def _to_rgb(t, v):
    if t in _SCALAR:
        f = _f32(v)
        return (f, f, f)
    if t == "vec2":
        return (v[0], v[1], torch.zeros_like(v[0]))
    return (v[0], v[1], v[2])


# -- builtin function library ------------------------------------------------

def _ew(f):
    """Elementwise on a scalar or vector."""
    def run(args, ctx):
        t, v = args[0]
        if t in _SCALAR:
            return ("num", f(v))
        return (t, tuple(f(x) for x in v))
    return run


def _ew2(f):
    def run(args, ctx):
        at, av, bt, bv = _unify(*args[0], *args[1])
        if at in _SCALAR:
            return ("num", f(av, bv))
        return (at, tuple(f(x, y) for x, y in zip(av, bv)))
    return run


def _ew3(f):
    def run(args, ctx):
        at, av, bt, bv = _unify(*args[0], *args[1])
        at, av, ct, cv = _unify(at, av, *args[2])
        at, av, bt, bv = _unify(at, av, bt, bv)
        if at in _SCALAR:
            return ("num", f(av, bv, cv))
        return (at, tuple(f(x, y, z) for x, y, z in zip(av, bv, cv)))
    return run


def _vec_reduce(f):
    def run(args, ctx):
        t, v = args[0]
        if t in ("num", "int"):
            return ("num", v)
        return ("num", f(v))
    return run


def _noise_core(args, which):
    t, v = args[0]
    if t in ("num", "int"):
        x, y = v, torch.zeros_like(v)
    else:
        x, y = v[0], v[1]
    if len(args) > 1:
        seed = args[1][1]
        x = x + seed * 17.17
    if which == "cell":
        return _hash2(_floor_i32(x), _floor_i32(y))
    if which == "fbm":
        amp, val, tot = 1.0, 0.0, 0.0
        for o in range(4):
            val = val + amp * _value_noise(x * (2 ** o), y * (2 ** o))
            tot += amp
            amp *= 0.5
        return val / tot
    if which == "voronoi":
        x0 = _floor_i32(x)
        y0 = _floor_i32(y)
        best = torch.full_like(x, 1e9)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cx, cy = x0 + dx, y0 + dy
                px = cx.to(torch.float32) + _hash2(cx, cy)
                py = cy.to(torch.float32) + _hash2(cy, cx)
                best = torch.minimum(best, (px - x) ** 2 + (py - y) ** 2)
        return torch.sqrt(best)
    return _value_noise(x, y)


def _mk_noise(which, color_out):
    def run(args, ctx):
        nv = _noise_core(args, which)
        if not color_out:
            return ("num", nv)
        return ("vec4", (nv, nv, nv, torch.ones_like(nv)))
    return run


def _call_builtin(name, args, ctx):
    if name in _FUNCS1:
        try:
            return _FUNCS1[name](args, ctx)
        except PExprError:
            raise
        except (IndexError, TypeError, ValueError, RuntimeError) as e:
            # arity or shape misuse inside a builtin is an expression
            # error, not an internal failure
            raise PExprError(f"PExpr: bad arguments to '{name}': {e}")
    raise PExprError(f"PExpr: unknown function '{name}'")


def _safe_norm(args, ctx):
    t, v = args[0]
    if t in ("num", "int"):
        return ("num", torch.sign(v))
    l2 = sum(x * x for x in v)
    inv = torch.where(l2 > 0, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)),
                      0.0)
    return (t, tuple(x * inv for x in v))


def _clip(x, lo, hi):
    """jnp.clip with scalar or tensor bounds: min(max(x, lo), hi)."""
    if not isinstance(lo, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _build_funcs():
    f = {}
    for nm, fn in [
        ("abs", torch.abs), ("acos", lambda x: torch.arccos(_clip(x, -1, 1))),
        ("asin", lambda x: torch.arcsin(_clip(x, -1, 1))),
        ("atan", torch.arctan), ("cbrt", _cbrt), ("ceil", torch.ceil),
        ("cos", torch.cos), ("cosh", torch.cosh),
        ("deg", torch.rad2deg), ("exp", torch.exp), ("exp2", torch.exp2),
        ("floor", torch.floor), ("fract", lambda x: x - torch.floor(x)),
        ("log", lambda x: torch.log(torch.clamp(x, min=1e-30))),
        ("log10", lambda x: torch.log10(torch.clamp(x, min=1e-30))),
        ("log2", lambda x: torch.log2(torch.clamp(x, min=1e-30))),
        ("rad", torch.deg2rad), ("round", torch.round), ("sign", torch.sign),
        ("sin", torch.sin), ("sinh", torch.sinh),
        ("sqrt", lambda x: torch.sqrt(torch.clamp(x, min=0.0))),
        ("tan", torch.tan), ("tanh", torch.tanh), ("trunc", torch.trunc),
        ("smoothstep", lambda x: x * x * (3 - 2 * x)),
        ("smootherstep", lambda x: x * x * x * (x * (x * 6 - 15) + 10)),
        ("signbit", lambda x: (x < 0).to(torch.float32)),
    ]:
        f[nm] = _ew(fn)
    for nm, fn in [
        ("atan2", torch.atan2), ("fmod", _mod),
        ("max", torch.maximum), ("min", torch.minimum),
        ("pow", lambda x, y: torch.pow(torch.clamp(x, min=0.0)
                                       + 1e-30 * (x == 0), y)),
        ("snap", lambda x, y: torch.floor(x / torch.where(y == 0, 1.0, y))
         * y),
    ]:
        f[nm] = _ew2(fn)
    f["clamp"] = _ew3(_clip)
    f["wrap"] = _ew3(lambda x, lo, hi: lo + _mod(
        x - lo, torch.where(hi == lo, 1.0, hi - lo)))
    f["mix"] = _ew3(lambda a, b, t: a + (b - a) * t)
    f["mix_linear"] = f["mix"]
    f["pingpong"] = _ew2(lambda x, s: torch.where(
        s == 0, 0.0,
        torch.abs(_mod(x, 2 * torch.where(s == 0, 1.0, s)) - s)))

    def _select(args, ctx):
        ct, cv = args[0]
        at, av, bt, bv = _unify(*args[1], *args[2])
        if at in _SCALAR:
            return (at, torch.where(_cond(cv), av, bv))
        return (at, tuple(torch.where(_cond(cv), x, y)
                          for x, y in zip(av, bv)))
    f["select"] = _select

    def _vecn(n):
        def run(args, ctx):
            if len(args) == 1:
                t, v = args[0]
                s = v if t in ("num", "int") else v[0]
                return (f"vec{n}", tuple(s for _ in range(n)))
            vals = []
            for t, v in args:
                vals.append(v if t in ("num", "int") else v[0])
            return (f"vec{n}", tuple(vals[:n]))
        return run
    f["vec2"] = _vecn(2)
    f["vec3"] = _vecn(3)
    f["vec4"] = _vecn(4)

    def _color(args, ctx):
        vals = [v if t in ("num", "int") else v[0] for t, v in args]
        if len(vals) == 1:
            vals = vals * 3
        while len(vals) < 4:
            vals.append(torch.ones_like(vals[0]) if len(vals) == 3
                        else vals[-1])
        return ("vec4", tuple(vals[:4]))
    f["color"] = _color

    def _dot(args, ctx):
        _, a = args[0]
        _, b = args[1]
        return ("num", sum(x * y for x, y in zip(a, b)))
    f["dot"] = _dot

    def _cross(args, ctx):
        _, a = args[0]
        _, b = args[1]
        return ("vec3", (a[1] * b[2] - a[2] * b[1],
                         a[2] * b[0] - a[0] * b[2],
                         a[0] * b[1] - a[1] * b[0]))
    f["cross"] = _cross

    def _length(args, ctx):
        t, v = args[0]
        if t in ("num", "int"):
            return ("num", torch.abs(v))
        return ("num", torch.sqrt(torch.clamp(sum(x * x for x in v),
                                              min=0.0)))
    f["length"] = _length

    def _dist(args, ctx):
        _, a = args[0]
        _, b = args[1]
        return ("num", torch.sqrt(torch.clamp(
            sum((x - y) ** 2 for x, y in zip(a, b)), min=0.0)))
    f["dist"] = _dist
    f["norm"] = _safe_norm
    f["avg"] = _vec_reduce(lambda v: sum(v) / len(v))
    f["sum"] = _vec_reduce(lambda v: sum(v))

    def _lum(args, ctx):
        _, v = args[0]
        return ("num", 0.2126 * v[0] + 0.7152 * v[1] + 0.0722 * v[2])
    f["luminance"] = _lum

    def _angle(args, ctx):
        _, a = args[0]
        _, b = args[1]
        la = torch.sqrt(torch.clamp(sum(x * x for x in a), min=1e-30))
        lb = torch.sqrt(torch.clamp(sum(x * x for x in b), min=1e-30))
        d = sum(x * y for x, y in zip(a, b)) / (la * lb)
        return ("num", torch.arccos(torch.clamp(d, -1, 1)))
    f["angle"] = _angle

    def _reflect(args, ctx):
        _, i = args[0]
        _, nn = args[1]
        d = sum(x * y for x, y in zip(i, nn))
        return ("vec3", tuple(x - 2 * d * y for x, y in zip(i, nn)))
    f["reflect"] = _reflect

    def _bump(args, ctx):
        # bump(N, Nx, Ny, distance, dHdu, dHdv): perturb the shading normal
        # by a height-field gradient (reference texture/bump.art:3-11,
        # Transpiler.cpp:921). With the context's raw surface derivatives
        # the tilt is measured against |dP/du| (Cycles' bump node) instead
        # of the unit tangents the caller passes.
        _, n = args[0]
        _, nx = args[1]
        _, ny = args[2]
        dist = args[3][1]
        dhx = args[4][1]
        dhy = args[5][1]
        if ctx.dpdu is not None:
            l2u = sum(x * x for x in ctx.dpdu)
            l2v = sum(x * x for x in ctx.dpdv)
            ok = (l2u > 1e-16) & (l2v > 1e-16)
            nx = tuple(torch.where(ok, d, t) for d, t in zip(ctx.dpdu, nx))
            ny = tuple(torch.where(ok, d, t) for d, t in zip(ctx.dpdv, ny))

        def cr(a, b):
            return (a[1] * b[2] - a[2] * b[1],
                    a[2] * b[0] - a[0] * b[2],
                    a[0] * b[1] - a[1] * b[0])
        rx = cr(ny, n)
        ry = cr(n, nx)
        det = sum(x * y for x, y in zip(nx, rx))
        grad = tuple(x * dhx + y * dhy for x, y in zip(rx, ry))
        out = tuple(x * torch.abs(det) - g * torch.sign(det) * dist
                    for x, g in zip(n, grad))
        ln = torch.sqrt(torch.clamp(sum(x * x for x in out), min=1e-24))
        return ("vec3", tuple(x / ln for x in out))
    f["bump"] = _bump

    def _ensure_valid_reflection(args, ctx):
        # ensure_valid_reflection(Ng, V, N) (Transpiler.cpp:922 ->
        # core/sampling.art:120), core.frame's implementation
        from ..core.frame import ensure_valid_reflection as _evr
        from ..core.vec import Vec3 as _V3
        _, ng = args[0]
        _, i = args[1]
        _, n = args[2]
        out = _evr(_V3(*ng), _V3(*i), _V3(*n))
        return ("vec3", (out.x, out.y, out.z))
    f["ensure_valid_reflection"] = _ensure_valid_reflection

    def _checkerboard(args, ctx):
        # node_checkerboard2/3 (texture/checkerboard.art:1-2): parity of
        # wrap(v, 0, 2); the vec3 variant XORs in the z parity
        t, v = args[0]
        px = _i32(_mod(v[0], 2.0))
        py = _i32(_mod(v[1], 2.0))
        eq_xy = px == py
        if t == "vec2":
            out = eq_xy
        else:
            pz = _i32(_mod(v[2], 2.0))
            out = eq_xy == (pz == 1)
        return ("int", out.to(torch.float32))
    f["checkerboard"] = _checkerboard

    def _fresnel_dielectric(args, ctx):
        from ..core.fresnel import fresnel_dielectric
        _, cos_i = args[0]
        _, n1 = args[1]
        _, n2 = args[2] if len(args) > 2 else args[1]
        return ("num", fresnel_dielectric(n1 / torch.clamp(n2, min=1e-6),
                                          torch.abs(cos_i)).factor)
    f["fresnel_dielectric"] = _fresnel_dielectric

    def _num(args, ctx):
        t, v = args[0]
        return ("num", v if t in _SCALAR else v[0])
    f["num"] = _num
    f["int"] = _ew(torch.trunc)

    def _hash(args, ctx):
        t, v = args[0]
        if t in ("num", "int"):
            x, y = v, torch.zeros_like(v)
        else:
            x, y = v[0], v[1]
        return ("num", _hash2(_i32(x * 1024), _i32(y * 1024)))
    f["hash"] = _hash

    for nm in ("noise", "snoise", "pnoise", "perlin", "sperlin"):
        f[nm] = _mk_noise("value", False)
    for nm in ("cnoise", "cpnoise", "cperlin"):
        f[nm] = _mk_noise("value", True)
    f["fbm"] = _mk_noise("fbm", False)
    f["cfbm"] = _mk_noise("fbm", True)
    f["cellnoise"] = _mk_noise("cell", False)
    f["ccellnoise"] = _mk_noise("cell", True)
    f["voronoi"] = _mk_noise("voronoi", False)
    f["cvoronoi"] = _mk_noise("voronoi", True)

    def _smin(args, ctx):
        at, av, bt, bv = _unify(*args[0], *args[1])
        _, kv = args[2]

        def sm(a, b):
            h = torch.clamp(0.5 + 0.5 * (b - a) / torch.where(kv == 0, 1.0,
                                                               kv), 0, 1)
            return b + (a - b) * h - kv * h * (1 - h)
        if at in ("num", "int"):
            return ("num", sm(av, bv))
        return (at, tuple(sm(x, y) for x, y in zip(av, bv)))
    f["smin"] = _smin

    def _smax(args, ctx):
        (at, av), (bt, bv), (kt, kv) = args

        def neg(t_v):
            return (t_v[0], -t_v[1] if t_v[0] in ("num", "int")
                    else tuple(-x for x in t_v[1]))
        t, v = _smin([neg((at, av)), neg((bt, bv)), (kt, kv)], ctx)
        return neg((t, v))
    f["smax"] = _smax

    return f


_FUNCS1 = _build_funcs()


def looks_like_pexpr(s: str) -> bool:
    """Heuristic: a bare identifier is a texture reference, anything with
    operators, calls or digits is an expression."""
    return re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", s.strip()) is None
