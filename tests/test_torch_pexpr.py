"""PExpr in ignis_tpu_torch against ignis_tpu, on the CPU.

The port's compiler (ignis_tpu_torch/scene/pexpr.py) and the JAX one
evaluate the same expressions on the same contexts (make_shade_ctx of each
package, every variable filled from a numpy seed over 4,096 lanes): every
case of tests/test_pexpr.py, and a fixed set over every variable,
swizzle, operator and builtin, noise, `%`, `/0` and negative `**`
included, plus a seeded set of random compositions held node by node
(test_seeded_compositions_match_jax). Integer, comparison
and noise paths must match exactly; the rest within rtol 1e-6 / atol
1e-7 (NaN where the JAX package gives NaN), but for a normal chain
through ensure_valid_reflection and the jitted JAX bakes (rtol 1e-5). Also: the bakes
(render/bake.py), the build's constant folds and their guards, the
loaders' PExpr warnings, renders at spi 1 and 32x32 of a PExpr-textured
scene, a PExpr blend weight, a transform-normal scene and a PExpr medium
under volpath (spi 2) by the render bar of
tests/test_torch_render.py, and setParameter's live registry (the 4x
ratio of tests/test_runtime_api.py, with no rebuild)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.core.vec import Vec2 as JVec2
from ignis_tpu.models.texture import make_shade_ctx as j_ctx
from ignis_tpu.render import bake as jbake
from ignis_tpu.render.session import render_iteration as jax_iteration
from ignis_tpu.scene import pexpr as JP
from ignis_tpu.scene.build import TextureRegistry as JRegistry
from ignis_tpu_torch.core.vec import Vec2
from ignis_tpu_torch.models.texture import make_shade_ctx as t_ctx
from ignis_tpu_torch.render import bake as tbake
from ignis_tpu_torch.render.session import render_iteration
from ignis_tpu_torch.scene import pexpr as TP
from ignis_tpu_torch.scene.build import TextureRegistry as TRegistry

from test_components import BASE
from test_runtime_api import SCENE as RUNTIME_SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 4096
TEX_IDS = {"tex": 0, "img": 1}
PARAMS = {"tint": ("num", 0.3), "dir": ("vec3", (0.1, -0.2, 0.3)),
          "col": ("vec4", (0.5, 0.25, 0.125, 1.0))}
# the live values differ from the load-time constants: the registry wins
REGISTRY = {"tint": np.float32(0.7),
            "dir": np.array([0.4, 0.5, -0.6], np.float32)}


def _inputs(seed):
    rs = np.random.RandomState(seed)

    def f(lo, hi):
        return rs.uniform(lo, hi, N).astype(np.float32)

    def unit():
        v = rs.normal(size=(3, N)).astype(np.float32)
        return tuple(v / np.linalg.norm(v, axis=0))
    return dict(
        uv=(f(-2.5, 3.5), f(-2.5, 3.5)), point=tuple(f(-3, 3) for _ in "xyz"),
        normal=unit(), face_normal=unit(), tangent=unit(), bitangent=unit(),
        ray_dir=unit(), ray_org=tuple(f(-4, 4) for _ in "xyz"),
        prim_coords=(f(0, 1), f(0, 1)),
        entity_id=rs.randint(0, 9, N).astype(np.int32),
        pixel=(rs.randint(0, 64, N).astype(np.int32),
               rs.randint(0, 64, N).astype(np.int32)),
        frontside=rs.rand(N) < 0.5,
        dpdu=tuple(f(-2, 2) for _ in "xyz"),
        dpdv=tuple(f(-2, 2) for _ in "xyz"))


def _tex(uv, tid, like):
    """A texture lookup that both frameworks evaluate alike."""
    return (uv[0] * 0.5 + tid, uv[1] * uv[1], uv[0] * uv[1] - 0.25)


def contexts(seed=0, registry=True):
    """(JAX ShadeCtx, port ShadeCtx) of the same seeded inputs."""
    a = _inputs(seed)
    center, radius = (0.5, -0.25, 1.0), np.float32(2.5)

    def build(mk, V2, arr, reg):
        def v(key):
            x = a[key]
            return tuple(arr(c) for c in x) if isinstance(x, tuple) \
                else arr(x)
        return mk(V2(*v("uv")), point=v("point"), normal=v("normal"),
                  face_normal=v("face_normal"), ray_dir=v("ray_dir"),
                  ray_org=v("ray_org"), prim_coords=v("prim_coords"),
                  entity_id=v("entity_id"), pixel=v("pixel"),
                  frontside=v("frontside"), tangent=v("tangent"),
                  bitangent=v("bitangent"), scene_center=center,
                  scene_radius=arr(radius),
                  textures=lambda tid, uv: _tex(uv, tid, None),
                  registry=reg, dpdu=v("dpdu"), dpdv=v("dpdv"))
    jreg = ({k: jnp.asarray(v) for k, v in REGISTRY.items()}
            if registry else None)
    treg = ({k: torch.from_numpy(np.asarray(v)) for k, v in REGISTRY.items()}
            if registry else None)
    return (build(j_ctx, JVec2, jnp.asarray, jreg),
            build(t_ctx, Vec2, lambda x: torch.from_numpy(np.asarray(x)),
                  treg))


def _eval(src, ctxs, params=PARAMS, tex_ids=TEX_IDS):
    jt, jv = JP.Compiler(tex_ids, params).compile(src)(ctxs[0])
    tt, tv = TP.Compiler(tex_ids, params).compile(src)(ctxs[1])
    assert tt == jt, (src, tt, jt)
    if jt == "str":
        assert tv == jv
        return []
    if jt in ("num", "int", "bool"):
        jv, tv = (jv,), (tv,)
    return [(np.asarray(t.numpy(), np.float64),
             np.asarray(np.asarray(j), np.float64)) for t, j in zip(tv, jv)]


def check(src, ctxs, exact, params=PARAMS):
    for got, want in _eval(src, ctxs, params):
        got = np.broadcast_to(got, (N,))
        want = np.broadcast_to(want, (N,))
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=src)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       equal_nan=True, err_msg=src)


@pytest.fixture(scope="module")
def ctxs():
    return contexts(0)


# --- every case of tests/test_pexpr.py ---------------------------------------

TEST_PEXPR_CASES = [
    "1 + 2 * 3", "(1 + 2) * 3", "2^3", "-4 + 1", "7 % 3",
    "sin(Pi/2)", "cos(0)", "sqrt(16)", "abs(-3)",
    "vec3(1,2,3).zyx", "color(0.2, 0.4, 0.1, 0)", "vec3(1,2,3).y",
    "vec2(5, 7).xyxy",
    "dot(vec3(1,0,0), vec3(0,1,0))", "length(vec3(3,4,0))",
    "norm(vec3(0,0,2))", "avg(vec3(1,2,3))",
    "cross(vec3(1,0,0), vec3(0,1,0))",
    "uv.x", "uv.y * 2", "fract(2.75)",
    "select(1 < 2, 10, 20)", "select(uv.x > 0.5, 1, 0)",
    "1 < 2 && 3 > 2 ? 5 : 6",
    "mix(0, 10, 0.25)", "clamp(5, 0, 3)", "min(4, 7)", "max(4, 7)",
    "myval / 2",
    "4*norm(Np.xyzz)", "0.2*(color(1)-norm(Np.xyzz))",
    "perlin(uv * 10)", "fbm(uv.yx * 4)",
    "checkerboard(vec2(0.5, 0.5))", "checkerboard(vec2(1.5, 0.5))",
    "checkerboard(vec3(0.5, 0.5, 0.0))", "checkerboard(vec3(1.5, 0.5, 0.0))",
    "checkerboard(vec3(0.5, 0.5, 1.5))", "checkerboard(vec3(-0.5, 0.5, 0.0))",
    "bump(vec3(0,0,1), vec3(1,0,0), vec3(0,1,0), 1.0, 0.5, 0.0)",
    "ensure_valid_reflection(vec3(0,0,1), vec3(0,0,1), vec3(0.1, 0, 0.995))",
    "ensure_valid_reflection(vec3(0,0,1), vec3(-0.995, 0, 0.0995), "
    "vec3(1, 0, 0.01))",
]


@pytest.mark.parametrize("uv", [(0.25, 0.5), (0.3, 0.6)])
def test_pexpr_cases_match_jax(uv):
    """tests/test_pexpr.py's expressions on its constant-uv contexts
    (make_shade_ctx of a uv alone), every lane, both uv pairs it uses."""
    u = np.full(N, uv[0], np.float32)
    v = np.full(N, uv[1], np.float32)
    cs = (j_ctx(JVec2(jnp.asarray(u), jnp.asarray(v))),
          t_ctx(Vec2(torch.from_numpy(u), torch.from_numpy(v))))
    for src in TEST_PEXPR_CASES:
        check(src, cs, exact=False, params={"myval": ("num", 42.0)})


def test_pexpr_cases_on_full_contexts_match_jax(ctxs):
    for src in TEST_PEXPR_CASES:
        check(src, ctxs, exact=False, params={"myval": ("num", 42.0)})


@pytest.mark.parametrize("src", ["unknown_fn(1)", "1 +", "uv.q",
                                 "dot(1)", "nope + 1", "vec3(1,2,3) + "
                                 "vec2(1,2)", "'str' 1"])
def test_errors_match_jax(ctxs, src):
    """The expressions that fail in the JAX compiler fail here, with
    PExprError."""
    with pytest.raises(JP.PExprError):
        JP.Compiler(TEX_IDS, PARAMS).compile(src)(ctxs[0])
    with pytest.raises(TP.PExprError):
        TP.Compiler(TEX_IDS, PARAMS).compile(src)(ctxs[1])


# --- every variable, swizzle, operator and builtin ------------------------------

EXACT = [
    # variables and constants
    "uv", "uvw", "P", "Np", "N", "Ng", "Nx", "Ny", "V", "Rd", "Ro",
    "prim_coords", "entity_id", "Ix", "Iy", "frontside", "Pi", "E", "Eps",
    "Inf", "NumMax", "NumMin", "true", "false", "tint", "dir", "col", "tex",
    "img(uv.yx)", "tex(prim_coords)",
    # swizzles
    "P.zyx", "N.xxyy", "col.rgba", "col.bgr", "uv.yx", "P.z", "col.a",
    "tint.x", "dir.zzz",
    # operators
    "uv.x + uv.y", "P - N", "P * 2", "-P", "+uv.x", "!frontside",
    "uv.x % 0.7", "P % vec3(0.5, -0.75, 2)", "-uv.y % 1.5", "uv.x % 0",
    "uv.x < uv.y", "uv.x <= 0.5", "P > N", "P >= 0", "uv.x == uv.x",
    "uv.x != 0.5", "frontside && uv.x > 0", "frontside || uv.y > 1",
    "frontside ? P : N", "uv.x > 0 ? 1 : 2",
    # integer and noise paths
    "floor(P)", "ceil(uv)", "trunc(P * 3)", "round(uv * 4)", "int(uv.x * 7)",
    "fract(P)", "sign(uv)", "signbit(uv.x)", "abs(P)",
    "hash(uv)", "hash(uv.x)", "cellnoise(uv * 3)", "ccellnoise(P.xy * 2)",
    "noise(uv * 5)", "snoise(uv)", "pnoise(P.xz)", "perlin(uv * 16)",
    "sperlin(uv, 2)", "cnoise(uv * 3)", "cpnoise(P.yz)", "cperlin(uv, 1)",
    "fbm(uv * 3)", "cfbm(P.xy)",
    "checkerboard(uv * 8)", "checkerboard(uvw * 5)", "checkerboard(P)",
    "max(P, N)", "min(uv.x, uv.y)", "clamp(P, -1, 1)",
    "select(uv.x > uv.y, P, N)", "select(frontside, 1, 0)",
    "vec2(uv.y)", "vec3(1, uv.x, P)", "vec4(P, 1)", "color(0.5)",
    "color(uv.x, uv.y, 0)", "color(1, 2, 3, 4)", "num(P)", "num(uv.x)",
    "snap(uv, 0.25)", "snap(P, 0)", "fmod(P, 0.3)", "wrap(P, -1, 2)",
    "wrap(uv.x, 1, 1)", "pingpong(uv, 0.5)", "pingpong(uv.x, 0)",
    "sum(P)", "avg(col)", "mix(P, N, 0.25)", "mix_linear(uv.x, 2, uv.y)",
    "smoothstep(uv.x)", "smootherstep(uv)", "reflect(V, N)",
    "luminance(col)", "cross(P, N)", "dot(P, N)",
    "checkerboard(uv * 8) * 0.5 + perlin(uv * 16)",
]

CLOSE = [
    # voronoi's cells are exact, its distance a square root (XLA's CPU
    # sqrt is not always correctly rounded: an ulp on some lanes)
    "voronoi(uv * 5)", "cvoronoi(P.xy * 2, 3)",
    # transcendentals, roots and divisions
    "sin(P)", "cos(uv)", "tan(uv.x)", "asin(uv.x)", "acos(N.z)", "atan(P)",
    "atan2(P.x, P.y)", "sinh(uv.x)", "cosh(uv)", "tanh(P)", "exp(uv)",
    "exp2(uv.y)", "log(uv.x)", "log10(P)", "log2(uv)", "sqrt(P)", "cbrt(P)",
    "deg(uv.x)", "rad(P)", "pow(P, 2.5)", "pow(uv.x, 0)", "P ^ 2",
    "uv.x ** uv.y", "(-2) ** 0.5", "-2 ** 2", "P / uv.x", "uv / 0",
    "1 / 0", "P / vec3(0, 1, 2)", "length(P)", "length(uv.x)", "dist(P, N)",
    "norm(P)", "norm(uv.x)", "angle(P, N)", "smin(uv.x, uv.y, 0.3)",
    "smax(P, N, 0.2)", "smin(P, N, 0)",
    "bump(N, Nx, Ny, 0.3, uv.x, uv.y)",
    "ensure_valid_reflection(Ng, V, N)",
    "fresnel_dielectric(dot(V, N), 1, 1.5)", "fresnel_dielectric(uv.x, 1.3)",
    "4 * norm(Np.xyzz)", "0.2 * (color(1) - norm(Np.xyzz))",
    "tint * checkerboard(uv * 8) * (0.5 + 0.5 * perlin(uv * 16))",
    "0.05 + 0.3 * perlin(uv * 8)",
]


# chains whose square roots' ulps (see voronoi) the normal clamp's
# branches amplify: within rtol 1e-5
CHAINED = [
    "ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.1, "
    "0.5 * voronoi(uv * 5), fbm(uv * 3)))",
]


@pytest.mark.parametrize("src", CHAINED)
def test_chained_paths_match_jax(ctxs, src):
    for got, want in _eval(src, ctxs):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=src)


@pytest.mark.parametrize("src", EXACT)
def test_exact_paths_match_jax(ctxs, src):
    check(src, ctxs, exact=True)


@pytest.mark.parametrize("src", CLOSE)
def test_float_paths_match_jax(ctxs, src):
    check(src, ctxs, exact=False)


_LEAVES = ["uv.x", "uv.y", "P.x", "N.z", "Np.y", "V.x", "tint", "Ix",
           "entity_id", "2.5", "0.5", "3", "prim_coords.y"]
_UNARY = ["abs", "floor", "fract", "sin", "sqrt", "exp", "perlin",
          "cellnoise", "hash", "trunc"]
_BINARY = ["+", "-", "*", "/", "%", "^", "<", "min", "max", "atan2",
           "pow", "smoothstep_mix"]


def _random_tree(rs, depth):
    """A random scalar composition: a leaf's source, or (format, children)
    where the format string takes the children's sources."""
    if depth == 0 or rs.rand() < 0.25:
        return _LEAVES[rs.randint(len(_LEAVES))]
    if rs.randint(3) == 0:
        f = _UNARY[rs.randint(len(_UNARY))]
        return (f + "({0})", (_random_tree(rs, depth - 1),))
    op = _BINARY[rs.randint(len(_BINARY))]
    kids = (_random_tree(rs, depth - 1), _random_tree(rs, depth - 1))
    if op in ("min", "max", "atan2", "pow"):
        return (op + "({0}, {1})", kids)
    if op == "smoothstep_mix":
        return ("mix({0}, {1}, smoothstep(uv.x))", kids)
    if op == "<":
        return ("select({0} < {1}, {0}, {1})", kids)
    return ("({0} " + op + " {1})", kids)


def _render(tree):
    if isinstance(tree, str):
        return tree
    return tree[0].format(*map(_render, tree[1]))


# the node formats whose result rounds differently in the two libraries:
# their transcendentals, and division (XLA's CPU flushes denormals)
_ROUNDED = ("sqrt(", "sin(", "exp(", "atan2(", "pow(", " ^ ", " / ")


def _eval_on(ctxs, src, kids):
    """`src` over the textures a0, a1 (each returning one child's values
    in all three channels): [N] float64 values of JAX, of the port."""
    arrs = [np.ascontiguousarray(np.broadcast_to(k, (N,)), np.float32)
            for k in kids]
    ja = [jnp.asarray(a) for a in arrs]
    ta = [torch.from_numpy(a) for a in arrs]
    cs = (ctxs[0]._replace(textures=lambda tid, uv: (ja[tid],) * 3),
          ctxs[1]._replace(textures=lambda tid, uv: (ta[tid],) * 3))
    ((got, want),) = _eval(src, cs, tex_ids={"a0": 0, "a1": 1})
    return np.broadcast_to(want, (N,)), np.broadcast_to(got, (N,))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_compositions_match_jax(ctxs, seed):
    """25 random compositions of variables, operators and builtins a
    seed, every node on every lane. An ulp where the libraries round
    differently (a sine, a root) grows through a later floor, hash or
    cancellation, so the compositions are held node by node: (1) each
    node's operation on JAX's values of its children (fed in as
    textures) gives the same result in both frameworks, exactly, or
    within rtol 1e-6 / atol 1e-7 for the _ROUNDED formats; (2) in each
    framework, the whole composition equals its node's operation on that
    framework's own values of the children, exactly, so the compiled
    composition is the chain of its operations."""
    rs = np.random.RandomState(100 + seed)
    for _ in range(25):
        tree = _random_tree(rs, 4)
        vals = {}   # a subtree's source -> (JAX values, port values)

        def full(t):
            src = _render(t)
            if src not in vals:
                ((got, want),) = _eval(src, ctxs)
                vals[src] = (np.broadcast_to(want, (N,)),
                             np.broadcast_to(got, (N,)))
            return vals[src]

        def visit(t):
            if isinstance(t, str):
                return
            for k in t[1]:
                visit(k)
            src = t[0].format(*[f"a{i}.x" for i in range(len(t[1]))])
            kids = [full(k) for k in t[1]]
            want, got = _eval_on(ctxs, src, [k[0] for k in kids])
            if any(r in t[0] for r in _ROUNDED):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           equal_nan=True, err_msg=src)
            else:
                np.testing.assert_array_equal(got, want, err_msg=src)
            j_full, t_full = full(t)
            np.testing.assert_array_equal(j_full, want, err_msg=_render(t))
            np.testing.assert_array_equal(
                t_full, _eval_on(ctxs, src, [k[1] for k in kids])[1],
                err_msg=_render(t))
        visit(tree)


def test_registry_values_win_and_constants_stay(ctxs):
    """A declared parameter reads the registry's value where the context
    has one, and the load-time constant where it has none."""
    for got, want in _eval("tint", ctxs):
        assert (got == np.float32(0.7)).all() and (want == got).all()
    cs = contexts(0, registry=False)
    for got, want in _eval("col * tint", cs):
        np.testing.assert_array_equal(got, want)
    assert float(_eval("tint", cs)[0][0][0]) == pytest.approx(0.3)


def test_looks_like_pexpr_matches_jax():
    for s in ["tex", " tex ", "tex1", "uv.x", "1", "color(1)", "a+b", "_x"]:
        assert TP.looks_like_pexpr(s) == JP.looks_like_pexpr(s)


# --- bakes and the build's constant folds -------------------------------------------

@pytest.mark.parametrize("expr", [
    "color(uv.x, uv.y, 0.5)", "checkerboard(uv * 8) * perlin(uv * 16)",
    "tint * voronoi(P.xy * 4)", "vec3(Ix, Iy, 0) / 16"])
def test_bake_texture2d_matches_jax(expr):
    params = {"tint": ("num", 0.4)}
    a = tbake.bake_texture2d(expr, 24, 16, parameters=params, device="cpu")
    b = jbake.bake_texture2d(expr, 24, 16, parameters=params)
    assert a.shape == (16, 24, 3) and a.dtype == np.float32
    # the JAX bake is one jitted program, whose fused arithmetic may
    # contract products into FMAs: within rtol 1e-5
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_bake_texture_average_matches_jax():
    a = tbake.bake_texture_average("fbm(uv * 6) * color(1, 0.5, 0.25)",
                                   res=32, device="cpu")
    b = jbake.bake_texture_average("fbm(uv * 6) * color(1, 0.5, 0.25)",
                                   res=32)
    np.testing.assert_allclose(a, b, rtol=1e-6)


FOLDS = [
    "color(0.25, 0.5, 0.75, 1.0)", "0.5 * color(1, 0.2, 0.1)", "tint * 2",
    "vec3(1, 2, 3)", "checkerboard(vec2(0.5, 0.5))", "tex * 0.5",
    "select(checkerboard(uvw * 5.0) == 1, color(0.8, 0.8, 0.8, 1), "
    "color(0.2, 0.2, 0.2, 1))",
    "select(checkerboard(uvw * 10.0) == 1, color(1,1,1,1), color(0,0,0,1))",
    "perlin(P.xy)", "hash(Ix)", "unknown(1)", "1 +", "sqrt(-1)",
]


@pytest.mark.parametrize("expr", FOLDS)
def test_constant_folds_match_jax(expr):
    """TextureRegistry.eval_constant_color and eval_constant_number, their
    guards included: expressions reading a declared parameter or a
    spatial input never fold, the others fold where two probes agree."""
    params = {"tint": {"type": "number", "value": 0.3}}
    jr, tr = JRegistry([], params), TRegistry([], params)
    jr.name_to_tex["tex"] = tr.name_to_tex["tex"] = 0
    a, b = tr.eval_constant_color(expr), jr.eval_constant_color(expr)
    assert (a is None) == (b is None), expr
    if a is not None:
        np.testing.assert_allclose(a, b, rtol=1e-6)
    a, b = tr.eval_constant_number(expr), jr.eval_constant_number(expr)
    assert (a is None) == (b is None), expr
    if a is not None:
        np.testing.assert_allclose(a, b, rtol=1e-6, equal_nan=True)


def test_resolve_color_degrades_like_jax():
    """An expression that does not compile or evaluate gives -1 and the
    same warning as the JAX build; a good one a PEXPR texture, cached."""
    for src in ("unknown_fn(uv)", "uv +", "nope * 2"):
        jw, tw = [], []
        assert JRegistry(jw).resolve_color(src, "x") == \
            TRegistry(tw).resolve_color(src, "x") == -1
        assert tw == jw
    tr = TRegistry([])
    assert tr.resolve_color("uv.x * 2", "x") == 0
    assert tr.resolve_color("uv.x * 2", "x") == 0
    assert tr.descs[0].fn is not None


# --- renders ----------------------------------------------------------------------

def render_bar(got, ref):
    """tests/test_torch_render.py:348's bar: >= 99% of pixels within rtol
    1e-3 / atol 1e-4 and the means within 0.5%."""
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - ref.mean()) <= 0.005 * abs(ref.mean()) + 1e-6


def render_both(scene, spi=1):
    """(port image, JAX image, port Runtime) of one JSON scene, each
    loaded by its own package: iteration 0 at spi `spi`."""
    text = json.dumps(scene)
    jrt = ignis_tpu.loadFromString(text, spi=spi)
    ref = np.asarray(jax_iteration(jrt.scene, jrt.settings, jnp.uint32(0),
                                   jnp.uint32(0)))
    rt = ignis_tpu_torch.loadFromString(text, device="cpu", spi=spi)
    assert rt.warnings == list(jrt.warnings)
    return render_iteration(rt.scene, rt.settings, 0, 0).numpy(), ref, rt


FLOOR_EXPR = "tint * checkerboard(uv*8) * (0.5 + 0.5*perlin(uv*16))"


def pexpr_scene():
    """BASE (tests/test_components.py) with S9's floor texture, and a quad
    whose colour, roughness and ior are PExpr strings (folded at load)
    beside one with a PExpr colour texture."""
    sc = json.loads(json.dumps(BASE))
    sc["parameters"] = {"tint": 0.9}
    sc["textures"] = [{"type": "expr", "name": "floor", "expr": FLOOR_EXPR}]
    sc["bsdfs"] = [
        {"type": "diffuse", "name": "g", "reflectance": "floor"},
        {"type": "roughplastic", "name": "p",
         "diffuse_reflectance": "color(0.2, 0.4, 0.6, 1)",
         "roughness": "0.05 + 0.3*perlin(uv*8)", "int_ior": "1.4 + 0.1"},
        {"type": "diffuse", "name": "d",
         "reflectance": "color(uv.x, fbm(uv*4), voronoi(uv*6))"}]
    for i, (name, x) in enumerate((("p", 0.6), ("d", -0.6))):
        sc["shapes"].append({"type": "rectangle", "name": f"Q{i}",
                             "width": 1.0, "height": 1.0,
                             "flip_normals": True})
        sc["entities"].append({"name": f"Q{i}", "shape": f"Q{i}",
                               "bsdf": name,
                               "transform": [{"translate": [x, 0, -0.5]}]})
    return sc


def test_pexpr_scene_renders_as_jax():
    got, ref, rt = render_both(pexpr_scene())
    render_bar(got, ref)
    assert rt.settings.texture_descs[0].fn is not None
    assert got.mean() > 0.01


def test_pexpr_blend_weight_renders_as_jax():
    """A blend whose weight is a PExpr (a PEXPR texture read for the top
    blend's weight) over untextured children: the JAX package reads a
    blend scene's rows untextured (ROADMAP queue 3), so no row here has
    a colour texture."""
    sc = json.loads(json.dumps(BASE))
    sc["bsdfs"] = [
        {"type": "diffuse", "name": "g", "reflectance": [0.6, 0.6, 0.6]},
        {"type": "plastic", "name": "p",
         "diffuse_reflectance": [0.2, 0.4, 0.6]},
        {"type": "diffuse", "name": "d", "reflectance": [0.9, 0.3, 0.1]},
        {"type": "blend", "name": "b", "first": "p", "second": "d",
         "weight": "cellnoise(uv * 4)"},
        {"type": "mask", "name": "m", "bsdf": "d",
         "opacity": "0.5 + 0.5 * checkerboard(uv * 6)"}]
    for i, (name, x) in enumerate((("b", 0.6), ("m", -0.6))):
        sc["shapes"].append({"type": "rectangle", "name": f"Q{i}",
                             "width": 1.0, "height": 1.0,
                             "flip_normals": True})
        sc["entities"].append({"name": f"Q{i}", "shape": f"Q{i}",
                               "bsdf": name,
                               "transform": [{"translate": [x, 0, -0.5]}]})
    got, ref, rt = render_both(sc)
    render_bar(got, ref)
    assert rt.settings.has_blend


def transform_scene():
    sc = json.loads(json.dumps(BASE))
    sc["bsdfs"] = [
        {"type": "diffuse", "name": "inner", "reflectance": [0.8, 0.7, 0.6]},
        {"type": "transform", "name": "g", "bsdf": "inner",
         "normal": "ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.1, "
                   "0.5*voronoi(uv*5), fbm(uv*3)))"}]
    return sc


def test_transform_normal_scene_renders_as_jax():
    got, ref, rt = render_both(transform_scene())
    render_bar(got, ref)
    assert 3 in {int(k) for k in rt.scene.materials.bump_kind}


def test_transform_identity_normal_matches_inner():
    """tests/test_components.py:562 on the port: normal "N" is a no-op."""
    plain = json.loads(json.dumps(BASE))
    wrapped = json.loads(json.dumps(BASE))
    wrapped["bsdfs"] = [
        {"type": "diffuse", "name": "inner", "reflectance": [0.8, 0.8, 0.8]},
        {"type": "transform", "name": "g", "bsdf": "inner", "normal": "N"}]
    a = ignis_tpu_torch.loadFromString(json.dumps(plain), device="cpu",
                                       spi=4).step().framebuffer(True)
    b = ignis_tpu_torch.loadFromString(json.dumps(wrapped), device="cpu",
                                       spi=4).step().framebuffer(True)
    assert torch.allclose(a, b, atol=1e-5)


def pexpr_fog_scene():
    """tests/test_compaction.py:88 VOL_SCENE at 32x32, max_depth 3, its
    ball at subdivisions 1 (80 triangles, dense in both packages), the fog
    absorbing only with the gate scene's PExpr as sigma_a (a scattering
    fog meets the reference's volpath faults, ROADMAP queue 3)."""
    from test_compaction import VOL_SCENE
    sc = json.loads(json.dumps(VOL_SCENE))
    sc["film"] = {"size": [32, 32]}
    sc["technique"]["max_depth"] = 3
    sc["shapes"][1]["subdivisions"] = 1
    sc["media"][0].update(sigma_a="0.6*(color(1)-norm(Np.xyzz))",
                          sigma_s=[0.0, 0.0, 0.0])
    return sc


def test_pexpr_medium_renders_as_jax():
    """A PExpr sigma under volpath, read where a lane enters the medium
    (medium.eval_medium_at), against ignis_tpu by the render bar."""
    got, ref, rt = render_both(pexpr_fog_scene(), spi=2)
    render_bar(got, ref)
    assert rt.settings.medium_exprs[0][0] is not None
    # the closure makes a difference: a constant zero fog renders brighter
    sc = pexpr_fog_scene()
    sc["media"][0]["sigma_a"] = [0.0, 0.0, 0.0]
    clear = ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                           spi=2)
    assert render_iteration(clear.scene, clear.settings, 0,
                            0).numpy().mean() > got.mean()


def test_set_parameter_updates_the_registry_in_place():
    """tests/test_runtime_api.py:27 on the port: tint 0.2 -> 0.8 gives 4x
    the image through the live registry, with no rebuild and the same
    tensor; the JAX package's images agree; a camera parameter moves the
    image; an undeclared parameter rebuilds before the next step."""
    text = json.dumps(RUNTIME_SCENE)
    rt = ignis_tpu_torch.loadFromString(text, device="cpu", spi=8)
    jrt = ignis_tpu.loadFromString(text, spi=8)
    reg = rt.scene.registry["tint"]
    rt.step()
    jrt.step()
    a = rt.framebuffer(normalized=True).numpy()
    render_bar(a, np.asarray(jrt.framebuffer(normalized=True)))
    rt.setParameter("tint", 0.8)
    jrt.setParameter("tint", 0.8)
    rt.reset()
    jrt.reset()
    rt.step()
    jrt.step()
    b = rt.framebuffer(normalized=True).numpy()
    render_bar(b, np.asarray(jrt.framebuffer(normalized=True)))
    assert abs(b.mean() / a.mean() - 4.0) < 0.01
    assert rt.rebuilds == 0 and rt.scene.registry["tint"] is reg
    assert float(reg) == pytest.approx(0.8)
    assert rt.getParameter("tint") == 0.8
    rt.setParameter("__camera_eye", [0, 0, -4])
    rt.reset()
    c = rt.step().framebuffer(normalized=True).numpy()
    assert abs(c.mean() - b.mean()) > 1e-4 and rt.rebuilds == 0
    rt.setParameter("other", 1.0)
    rt.reset()
    rt.step()
    assert rt.rebuilds == 1 and rt.getParameter("other") == 1.0
    with pytest.raises(ValueError, match="shape"):
        vec = ignis_tpu_torch.loadFromString(json.dumps(dict(
            RUNTIME_SCENE, parameters={"v": {"type": "vector",
                                             "value": [1, 2, 3]}})),
            device="cpu", spi=1)
        vec.setParameter("v", [1, 2])
