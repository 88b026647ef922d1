"""The compacting cascade over fixed buffers, replayed as CUDA graphs.

The port's counterpart of ignis_tpu's jitted cascade: cascade_lane_fn
(ignis_tpu/techniques/path.py:944-1026) under _compiled_iteration
(ignis_tpu/render/session.py:49-63), one device program a settings with
no host sync. `CascadeProgram` runs the stages of path.render_lanes
(compacting or not; path or volpath through technique_fns) as a fixed
sequence of programs over tensors allocated once:

- `start`: each lane's first camera sample into stage 0's state, the
  film zeroed, the budget set to spi * max_depth;
- `bounce(s)`: one gated bounce of stage s. It reads the flag `go` that
  the program before it published, writes where(go, bounce(state),
  state) into the stage's buffers and adds go to the stage's bounce
  count `it`. A gated-off bounce leaves every buffer as it was; its lanes
  enter the bounce dead, so the kernels cull all its rays;
- `finish(s)`: folds the stage's radiance into the film by original lane
  id, subtracts `it` from the budget and compacts the survivors (the
  stable argsort of ~alive) into stage s+1's buffers.

Each program ends by publishing go = (it < budget) & (alive > min_alive),
the test of render_lanes's stage loop, on the device. The iteration and
frame are 0-d int64 tensors filled before a run and the camera is the
program's own copy (`set_camera`), so one capture serves every step; the
live registry's tensors are read where they live.

The runner is techniques/program.Program's, which every captured program
shares: `run` queues the programs and reads each flag behind the device,
so each stage ends with one gated-off bounce; on the card `capture`
records each program once as a CUDA graph after a warm-up run, and `run`
replays them. An instanced scene's traces compact into fixed pair
buffers (program.py, ops/instanced.PairBudget). The film equals
render_lanes's bit for bit.

`DiffCascadeProgram` adds the reverse mode of render_lanes(remat=True)
for the albedo (the counterpart of path_trace_cascade_diff under
jax.value_and_grad): the same forward with each bounce's input state
checkpointed on the device, then a loss program, each stage's fold and
compaction adjoints and one bounce VJP (a recompute and
torch.autograd.grad) a bounce, as CUDA graphs in the same pool;
parallel/mesh.TrainProgram runs it for train_step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Color
from ..scenedata import RenderSettings, SceneData, tree_map
from . import path as pathlib
from .path import (SHRINK, RenderTables, bucket_chain, leaves, start_state,
                   technique_fns, with_leaves)
from .program import Program, _on


class Stage(NamedTuple):
    """One cascade stage's buffers: the technique's state ([size] leaves),
    each lane's pixel and original lane id (its film column)."""
    st: tuple
    px: torch.Tensor
    py: torch.Tensor
    l0: torch.Tensor
    min_alive: int      # the stage ends at this many alive lanes or fewer


class CascadeProgram(Program):
    """render_lanes's cascade for the lanes (pixels) x, y of one scene and
    settings over buffers allocated here; `tabs` are the render's tables,
    read by every run. `compact` as in render_lanes; `pool` as Program's."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, x, y, compact: bool = True, pool=None):
        n = x.shape[0]
        sizes = bucket_chain(n, pathlib.MIN_BUCKET) if compact else [n]
        super().__init__(scene, settings, tabs,
                         settings.spi * settings.max_depth + 2 * len(sizes),
                         pool)
        dev = self.device
        self.x, self.y = x, y
        self.initial, make = technique_fns(settings)
        i64 = dict(dtype=torch.int64, device=dev)
        self.budget = torch.zeros((), **i64)
        self.film = torch.zeros((3, n), dtype=torch.float32, device=dev)
        # each stage's bounces and the budget left after it
        self.stage_it = torch.zeros(len(sizes), **i64)
        self.stage_budget = torch.zeros(len(sizes), **i64)
        # each compaction's order: the stage's lanes that go on, in order
        self.order = [torch.empty(size, **i64) for size in sizes[1:]]
        with torch.no_grad(), _on(dev):
            st0 = start_state(self.scene, settings, x, y, self.iteration,
                              self.frame, self.initial)
        self.stages = []
        for s, size in enumerate(sizes):
            if s == 0:
                px, py, l0 = x, y, torch.arange(n, device=dev)
            else:
                px, py = x.new_empty(size), y.new_empty(size)
                l0 = torch.empty(size, **i64)
            st = tree_map(lambda a, size=size: a.new_empty(
                (size,) + tuple(a.shape[1:])), st0)
            last = s == len(sizes) - 1
            self.stages.append(Stage(st, px, py, l0,
                                     0 if last else size // SHRINK))
        self.bounce_fns = [make(self.scene, settings, self.tabs,
                                (g.px, g.py, self.iteration, self.frame))
                           for g in self.stages]

    # -- the programs ---------------------------------------------------
    def _publish(self, s: int) -> None:
        g = self.stages[s]
        self.go.copy_((self.it < self.budget)
                      & (g.st.alive.sum() > g.min_alive))

    def _start(self) -> None:
        st0 = start_state(self.scene, self.settings, self.x, self.y,
                          self.iteration, self.frame, self.initial)
        self._write(self.stages[0].st, st0)
        self.film.zero_()
        self.budget.fill_(self.settings.spi * self.settings.max_depth)
        self.it.zero_()
        self._publish(0)

    def _bounce(self, s: int) -> None:
        g = self.stages[s]
        go = self.go
        new = self.bounce_fns[s](g.st._replace(alive=g.st.alive & go))
        self._write(g.st, new, go)
        self.it.add_(go.to(torch.int64))
        self._publish(s)

    def _finish(self, s: int) -> None:
        g = self.stages[s]
        self.film.index_add_(1, g.l0, torch.stack(tuple(g.st.result)))
        self.budget.sub_(self.it)
        self.stage_it[s].copy_(self.it)
        self.stage_budget[s].copy_(self.budget)
        self.it.zero_()
        if s + 1 == len(self.stages):
            return
        nxt = self.stages[s + 1]
        order = self.order[s]
        order.copy_(torch.argsort((~g.st.alive).to(torch.int8),
                                  stable=True)[:nxt.l0.shape[0]])
        for b, v in zip(leaves(nxt.st) + [nxt.px, nxt.py, nxt.l0],
                        leaves(g.st) + [g.px, g.py, g.l0]):
            torch.index_select(v, 0, order, out=b)
        for c in nxt.st.result:
            c.zero_()
        self._publish(s + 1)

    def _program(self, key) -> None:
        kind, s = key
        if kind == "start":
            self._start()
        elif kind == "bounce":
            self._bounce(s)
        else:
            self._finish(s)

    def _sequence(self) -> Color:
        """One iteration: the film's [n] radiance sums over settings.spi
        samples, as views of the program's film."""
        self._call(("start", 0))
        for s in range(len(self.stages)):
            self._loop(("bounce", s))
            self._call(("finish", s))
        return Color(*self.film.unbind(0))

    def _keys(self) -> list:
        """Every program, in the order they are captured."""
        return [("start", 0)] + [(kind, s) for s in range(len(self.stages))
                                 for kind in ("bounce", "finish")]


class DiffCascadeProgram(CascadeProgram):
    """The gradient of loss_of(film) w.r.t. materials.base through the
    compacting cascade: the counterpart of path_trace_cascade_diff
    (ignis_tpu/techniques/path.py:1047-1103) under jax.value_and_grad,
    over buffers allocated here. `base` ([M] each) seeds the program's own
    albedo buffers (`set_base`); loss_of maps the film (a Color of [n]
    radiance sums) to a 0-d loss. `tabs` must be made with materials.base
    requiring grad (SceneInfo.mat_grad); their material table is replaced
    by the program's own.

    The forward is CascadeProgram's run, with every bounce's input state
    saved into a checkpoint slot of its stage indexed by the stage's
    bounce counter `it` (spi * max_depth + 1 slots a stage: a gated-off
    bounce saves into slot `it` without advancing it), each compaction's
    order kept, and the material table made at `start` from the albedo
    buffers. The host knows each stage's bounce count after the forward,
    so the backward (`train` queues it after the forward) waits for no
    flag:
    - `loss`: the loss and its gradient w.r.t. the film;
    - `adjoint(s)`, for each stage from the last: the fold's adjoint
      (the film's gradient at the stage's original lane ids) into the
      stage's result adjoints, the compaction's into its other carrying
      leaves (the next stage's input adjoints at the kept order; the
      result was zeroed at compaction, so none flows back through it),
      and the slot counter k set to the stage's bounce count;
    - `vjp(s)`, replayed once a bounce of the stage: k -= 1, slot k read,
      one bounce recomputed with the carrying leaves (path.grad_carriers)
      and the material table requiring grad, and torch.autograd.grad of
      the carrying outputs at the stage's adjoints, written back as the
      input adjoints; the table's gradient is added into `gacc`.
    Each bounce is recomputed exactly once, as in render_lanes(remat=True),
    whose loss this equals bit for bit and whose albedo gradient it equals
    up to the order of its sums (K3's scatter adds by atomics on the
    card). Every program ends with its results in buffers allocated here,
    so the graphs share one pool."""

    def __init__(self, scene: SceneData, settings: RenderSettings,
                 tabs: RenderTables, x, y, base: Color, loss_of, pool=None):
        dev = x.device
        with torch.no_grad():
            self.base = Color(*[c.detach().to(dev, torch.float32).clone()
                                for c in base])
            self.mtab = pathlib.material_table(scene, self.base)
        # a leaf on the same storage: the table the bounce VJPs read
        self.mtab_g = self.mtab.detach().requires_grad_()
        super().__init__(scene, settings, tabs._replace(mat=self.mtab), x, y,
                         compact=True, pool=pool)
        self.loss_of = loss_of
        make = technique_fns(settings)[1]
        # the forward's tables (its groups' pair budgets) with the table
        # that requires grad
        vjp_tabs = self.tabs._replace(mat=self.mtab_g)
        self.vjp_fns = [make(self.scene, settings, vjp_tabs,
                             (g.px, g.py, self.iteration, self.frame))
                        for g in self.stages]
        with _on(dev):
            with torch.no_grad():
                self._start()
            carriers = pathlib.grad_carriers(self.vjp_fns[0],
                                             self.stages[0].st)
        self.carry = tuple(i for i, c in enumerate(carriers) if c)
        st0 = self.stages[0].st
        self.result_leaves = tuple(
            i for i, a in enumerate(leaves(st0))
            if any(a is c for c in st0.result))
        n_slots = settings.spi * settings.max_depth + 1
        self.slots = [[a.new_empty((n_slots,) + tuple(a.shape))
                       for a in leaves(g.st)] for g in self.stages]
        self.adj = [[torch.zeros_like(leaves(g.st)[i]) for i in self.carry]
                    for g in self.stages]
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.g_film = torch.zeros_like(self.film)
        self.gacc = torch.zeros_like(self.mtab)

    @property
    def slot_bytes(self) -> int:
        """Bytes of the checkpoint slots, all stages."""
        return sum(a.numel() * a.element_size()
                   for st in self.slots for a in st)

    def set_base(self, base: Color) -> None:
        """Copy `base` into the program's albedo buffers."""
        with torch.no_grad():
            for d, s in zip(self.base, base):
                d.copy_(s)

    def base_grad(self) -> Color:
        """The last backward's gradient w.r.t. materials.base (copies)."""
        return Color(*[self.gacc[:, c].clone() for c in pathlib.BASE_COLS])

    # -- the programs ---------------------------------------------------
    def _start(self) -> None:
        self.mtab.copy_(pathlib.material_table(self.scene, self.base))
        super()._start()

    def _bounce(self, s: int) -> None:
        k = self.it.view(1)
        for slot, a in zip(self.slots[s], leaves(self.stages[s].st)):
            slot.index_copy_(0, k, a.unsqueeze(0))
        super()._bounce(s)

    def _loss(self) -> None:
        with torch.enable_grad():
            film = self.film.detach().requires_grad_()
            loss = self.loss_of(Color(*film.unbind(0)))
            (g,) = torch.autograd.grad(loss, film)
        self.loss.copy_(loss.detach())
        self.g_film.copy_(g)
        self.gacc.zero_()

    def _adjoint(self, s: int) -> None:
        g = self.stages[s]
        fold = torch.index_select(self.g_film, 1, g.l0)
        for j, i in enumerate(self.carry):
            a = self.adj[s][j]
            if i in self.result_leaves:
                a.copy_(fold[self.result_leaves.index(i)])
                continue
            a.zero_()
            if s + 1 < len(self.stages):
                a.index_copy_(0, self.order[s], self.adj[s + 1][j])
        self.k.copy_(self.stage_it[s])

    def _vjp(self, s: int) -> None:
        if not self.carry:
            return
        self.k.sub_(1)
        k = self.k.view(1)
        ins = [torch.index_select(slot, 0, k)[0]
               for slot in self.slots[s]]
        for i in self.carry:
            ins[i] = ins[i].detach().requires_grad_()
        with torch.enable_grad():
            out = leaves(self.vjp_fns[s](with_leaves(self.stages[s].st, ins)))
            pairs = [(out[i], a) for i, a in zip(self.carry, self.adj[s])
                     if out[i].requires_grad]
            # the adjoints are read as copies: a gradient may pass one
            # through unchanged, and it is written back below
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [ins[i] for i in self.carry]
                + [self.mtab_g], [a.clone() for _, a in pairs],
                allow_unused=True)
        for a, gi in zip(self.adj[s], grads):
            if gi is None:
                a.zero_()
            else:
                a.copy_(gi)
        if grads[-1] is not None:
            self.gacc.add_(grads[-1])

    def _program(self, key) -> None:
        kind, s = key
        if kind == "loss":
            self._loss()
        elif kind == "adjoint":
            self._adjoint(s)
        elif kind == "vjp":
            self._vjp(s)
        else:
            super()._program(key)

    def _keys(self) -> list:
        return super()._keys() + [("loss", 0)] + [
            (kind, s) for s in range(len(self.stages))
            for kind in ("adjoint", "vjp")]

    def _backward(self, bounces) -> None:
        """Queue the backward of a forward that ran `bounces` (by stage):
        the loss program, then each stage's adjoint and one bounce VJP a
        bounce it ran, last stage first. No flag is read: every count is
        known."""
        self._call(("loss", 0))
        for s in reversed(range(len(self.stages))):
            self._call(("adjoint", s))
            for _ in range(bounces[s]):
                self._call(("vjp", s))

    def _full_sequence(self) -> Color:
        film = self._sequence()
        self._backward(self._bounces)
        return film

    def train(self, iteration: int, frame: int) -> None:
        """One train step, forward and backward, into `loss` and
        `base_grad()`. A step whose traces overflowed a group's pair
        capacity is run again once the capacity is raised, so what the
        caller reads is always a step without an overflow."""
        self._execute(self._full_sequence, iteration, frame)
