"""The gradient mix: inverse rendering, users fitting vertex colours to a
photo.  Each step is ``grad.loss_and_grad`` over one tile of
``tile_pixels`` pixels at one sample per pixel, then an SGD update of
``tri_vc0``, ``tri_vc1`` and ``tri_vc2`` at the mix's ``lr``, clamped to
[0, 1], ending in a synchronise.  Steps run through the frame's pixels in
tile order, wrapping, with the sample id the pass through the frame.  The
target is the benchmark's own smooth image from the seed
(``inputs.grad_target``), not a render.

Set-up builds the one trainer and drives its first three steps (the
reference follows them); the window goes on with the same object, and
keeps one of its steps drawn from the seed (the window's last where it
ends sooner): the parameters before and after it, and its loss.

End to end: ``grad_step_s``, the window's wall time over the steps it
completed.  In a traced run each step's time from the end of the forward
(a probe synchronises there) to its end is kept as ``backward``.

Check (a training step's, by leaf: tri_vc0, tri_vc1, tri_vc2):
``loss_gap``, the largest relative gap of the three steps' losses;
``step1_gap``, the worst leaf's gap between the norms of the program's and
the reference's first update (the gradient as the optimizer takes it, times
``lr``, clamped), over the larger of the reference's norm of that leaf and
of the median leaf; ``change3_gap``, the same of the change after three
steps; ``window_loss_gap`` and ``window_step_gap``, the same of the kept
window step, which the reference replays from the program's parameters
before it (a step past the first pass: the wrap, sample ids of 1 and more).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs

LEAVES = ("tri_vc0", "tri_vc1", "tri_vc2")
FIRST_STEPS = 3
# The window step kept for the check is drawn from steps 5 to 44: past the
# first pass through the frame (5.3 tiles), and inside a 51 s window.
WINDOW_STEPS = (5, 45)


class Trainer:
    """The program's training step, its parameters and its feed."""

    def __init__(self, ctx, static, scene, cam, target):
        import torch

        self.ctx = ctx
        self.static, self.scene, self.cam = static, scene, cam
        w, h = ctx.size
        self.order = inputs.tiled_pixel_order(w, h)
        self.target = torch.as_tensor(target, device=ctx.device)
        self.params = {f: getattr(scene, f).clone() for f in LEAVES}
        self.seed = inputs.stream_seed(ctx.seed, 0)
        self.i = 0

    def step(self):
        import torch

        from paths_tpu_torch import grad as G

        ctx, w = self.ctx, self.ctx.size[0]
        pid, sid = inputs.grad_batch(self.order, self.i, ctx.mix["tile_pixels"])
        pid = torch.as_tensor(pid, device=ctx.device)
        sid = torch.as_tensor(sid, device=ctx.device)
        scene = self.scene._replace(**self.params)
        loss, g = G.loss_and_grad(self.static, scene, self.cam, (pid % w).to(torch.int32),
                                  (pid // w).to(torch.int32), pid, sid, self.seed,
                                  self.target[pid])
        lr = ctx.mix["lr"]
        with torch.no_grad():
            self.params = {f: (p - lr * g[f]).clamp_(0.0, 1.0) for f, p in self.params.items()}
        ctx.sync()
        self.i += 1
        return loss

    def host_params(self):
        return host(self.params)


def host(params: dict) -> dict:
    return {f: p.detach().cpu().numpy().astype(np.float64) for f, p in params.items()}


def vertices(scene) -> np.ndarray:
    """(triangles, 9) f32 on the host: each triangle's three vertices."""
    return np.concatenate([scene.tri_v0.cpu().numpy(), scene.tri_v1.cpu().numpy(),
                           scene.tri_v2.cpu().numpy()], axis=1)


def reference_rows(prog_verts: np.ndarray, ref_verts: np.ndarray):
    """Rows of the program's triangle arrays in the reference's order,
    matched by their vertices, which both read alike from the model file;
    None where the two sets of triangles are not the same."""
    if prog_verts.shape != ref_verts.shape:
        return None
    ps = np.lexsort(prog_verts.T[::-1])
    rs = np.lexsort(ref_verts.T[::-1])
    if not np.array_equal(prog_verts[ps], ref_verts[rs]):
        return None
    rows = np.empty(len(rs), np.int64)
    rows[rs] = ps
    return rows


def window_step(seed: int) -> int:
    return int(inputs.rng(seed, 17).integers(*WINDOW_STEPS))


def target_of(ctx):
    w, h = ctx.size
    return inputs.grad_target(ctx.seed, w, h, tuple(ctx.mix["target_grid"]),
                              ctx.mix["target_scale"])


def setup(ctx):
    static, scene, cam = ctx.port_scene()
    tr = Trainer(ctx, static, scene, cam, target_of(ctx))
    first = dict(p0=tr.host_params(), losses=[], verts=vertices(scene))
    for i in range(FIRST_STEPS):
        first["losses"].append(float(tr.step()))
        if i == 0:
            first["p1"] = tr.host_params()
    first["p3"] = tr.host_params()
    return dict(trainer=tr, first=first)


def window(state, ctx, seconds):
    tr = state["trainer"]
    j = window_step(ctx.seed)
    steps, walls, kept = 0, [], None
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        t_step = time.perf_counter()
        before = tr.params  # each step makes new tensors: no copy needed
        loss = tr.step()
        t = time.perf_counter()
        walls.append(t - t_step)
        if kept is None or kept[0] != j:
            kept = (tr.i - 1, before, tr.params, loss)
        fwd = ctx.obs.values.pop("forward_end", None)
        if fwd is not None:
            ctx.obs.span("backward", t - fwd)
        steps += 1
        ctx.tick()
    wall = time.perf_counter() - t0
    i, before, after, loss = kept
    records = dict(state["first"], window=dict(i=i, before=host(before), after=host(after),
                                               loss=float(loss)))
    return dict(metrics={"grad_step_s": wall / steps}, attempted=steps, unit_s=walls,
                records=records)


def _norms(a: dict, b: dict) -> dict:
    return {f: float(np.linalg.norm(a[f] - b[f])) for f in LEAVES}


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf.  A leaf the
    reference moves by under a thousandth of the median leaf (nought to
    rounding) is left out."""
    med = float(np.median(list(ref.values())))
    return max(abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30)
               for f in ref if ref[f] >= 1e-3 * med)


def _reference(ctx):
    """(scene, pixel order, target) of the reference."""
    import torch

    S = ctx.ref_scene()
    order = inputs.tiled_pixel_order(*ctx.size)
    return S, order, torch.as_tensor(target_of(ctx), device=ctx.device)


def _reference_step(ctx, ref, params: list, i: int, lanes_kept: float):
    """The reference's step i from params: (loss, parameters after)."""
    import torch

    from portbench.reference import trace as RT

    S, order, target = ref
    w, _ = ctx.size
    pid, sid = inputs.grad_batch(order, i, ctx.mix["tile_pixels"])
    keep = int(len(pid) * lanes_kept)
    pid = torch.as_tensor(pid[:keep], device=ctx.device)
    sid = torch.as_tensor(sid[:keep], device=ctx.device)
    leaves = [p.detach().requires_grad_(True) for p in params]
    col = RT.render_wave(S, S.camera, pid % w, pid // w, pid, sid, inputs.stream_seed(ctx.seed, 0),
                         vc_rows=torch.cat(leaves, dim=1))
    loss = torch.mean((col - target[pid]) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        after = [(p - ctx.mix["lr"] * g).clamp_(0.0, 1.0) for p, g in zip(leaves, grads)]
    return float(loss.detach()), after


def reference_steps(ctx, ref, n=FIRST_STEPS, lanes_kept: float = 1.0):
    """The reference's own trajectory from the scene's colours: (losses,
    parameters after step 1, after step n), by leaf in its own order.
    lanes_kept < 1 leaves out the rest of each tile's lanes, the mean taken
    over those kept (a fault the check must catch)."""
    params = [getattr(ref[0], f).clone() for f in LEAVES]
    out = dict(p0=host(dict(zip(LEAVES, params))), losses=[])
    for i in range(n):
        loss, params = _reference_step(ctx, ref, params, i, lanes_kept)
        out["losses"].append(loss)
        if i == 0:
            out["p1"] = host(dict(zip(LEAVES, params)))
    out["p3"] = host(dict(zip(LEAVES, params)))
    return out


def reference_window_step(ctx, ref, i: int, before: dict | None = None,
                          lanes_kept: float = 1.0):
    """The reference's step i from the parameters `before` (host arrays by
    leaf in the reference's order; the scene's colours where None), as the
    window's record: dict(i, before, after, loss)."""
    import torch

    if before is None:
        before = host({f: getattr(ref[0], f) for f in LEAVES})
    params = [torch.as_tensor(before[f], dtype=torch.float32, device=ctx.device) for f in LEAVES]
    loss, after = _reference_step(ctx, ref, params, i, lanes_kept)
    return dict(i=i, before=before, after=host(dict(zip(LEAVES, after))), loss=loss)


def check(records, ctx):
    ref = _reference(ctx)
    out = compare(records, reference_steps(ctx, ref))
    win = records["window"]
    rows = reference_rows(records["verts"], vertices(ref[0]))
    if rows is None:  # the program's triangles are not the scene's
        return dict(out, window_loss_gap=np.inf, window_step_gap=np.inf)
    before = {f: v[rows] for f, v in win["before"].items()}
    return dict(out, **compare_window(win, reference_window_step(ctx, ref, win["i"], before)))


def compare(records, ref) -> dict:
    losses = records["losses"]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "step1_gap": leaf_gap(_norms(records["p1"], records["p0"]),
                              _norms(ref["p1"], ref["p0"])),
        "change3_gap": leaf_gap(_norms(records["p3"], records["p0"]),
                                _norms(ref["p3"], ref["p0"])),
    }


def compare_window(win: dict, ref_win: dict) -> dict:
    """The window step's numbers; the norms of each side's change, so the
    order of the rows does not matter."""
    return {
        "window_loss_gap": abs(win["loss"] - ref_win["loss"]) / abs(ref_win["loss"]),
        "window_step_gap": leaf_gap(_norms(win["after"], win["before"]),
                                    _norms(ref_win["after"], ref_win["before"])),
    }


def control(ctx, fault: str):
    """The check's numbers with the reference in the program's place,
    computed in bfloat16 (fault "bf16") or with half of each tile's lanes
    left out and the mean taken over the rest ("half").  The window step
    (drawn from the seed as the window draws it) starts from the scene's
    colours."""
    from portbench.reference.precision import lower_precision

    j = window_step(ctx.seed)
    ref = _reference(ctx)
    want = reference_steps(ctx, ref), reference_window_step(ctx, ref, j)
    if fault == "bf16":
        with lower_precision():
            low_ref = _reference(ctx)
            got = reference_steps(ctx, low_ref), reference_window_step(ctx, low_ref, j)
    elif fault == "half":
        got = (reference_steps(ctx, ref, lanes_kept=0.5),
               reference_window_step(ctx, ref, j, lanes_kept=0.5))
    else:
        raise ValueError(f"grad mix: no control {fault!r}")
    return dict(compare(got[0], want[0]), **compare_window(got[1], want[1]))
