"""What lets the segmentation step be captured as a CUDA graph: the IoU
counts and the window kNN's tables without a host sync, held bit for bit to
the forms they replace, and a capturable AdamW only where a graph can hold
it.  ``card`` tests run a seg step on a CUDA device under torch's sync
debug mode, so that a host sync coming back into the step fails a test,
and capture and replay it; they skip without a card.

No JAX here, so that the card's tests run where JAX is not installed
(``python -m pytest --noconftest -m card tests/test_torch_sync_free.py``).
"""

import types

import pytest
import torch

from repsurf_torch.nn.metrics import intersection_and_union
from repsurf_torch.ops.kernels.knn_window import _SLACK, window_grid, window_tables
from repsurf_torch.train import optim

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")
    return torch.device("cuda")


def _bincount_iou(pred, target, num_class, ignore_index=255):
    """The counts as they were made before: three ``torch.bincount``s."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    keep = target != ignore_index

    def hist(x, mask):
        x = torch.where(mask, x, num_class)
        return torch.bincount(x, minlength=num_class + 1)[:num_class].to(torch.float32)

    inter = hist(pred, keep & (pred == target))
    area_pred = hist(pred, keep)
    area_target = hist(target, keep)
    return inter, area_pred + area_target - inter, area_target


@pytest.mark.parametrize("case", ["mixed", "none_ignored", "all_ignored", "one_class",
                                  "ignore_0", "wide_labels"])
def test_intersection_and_union_equals_the_bincount_form(case):
    """Bit-equal to the bincount form: random predictions over [B, N]
    labels with ignored entries, none or all of them ignored, a single
    class, another ignore label, labels past K (counted nowhere)."""
    g = torch.Generator().manual_seed(len(case))
    k, ignore = (13, 255) if case != "ignore_0" else (20, 0)
    pred = torch.randint(0, k, (3, 4000), generator=g)
    target = torch.randint(0, k, (3, 4000), generator=g)
    hit = torch.rand(3, 4000, generator=g) < 0.4
    target = torch.where(hit, pred, target)
    if case in ("mixed", "ignore_0"):
        target[torch.rand(3, 4000, generator=g) < 0.2] = ignore
    elif case == "all_ignored":
        target[:] = ignore
    elif case == "one_class":
        pred[:], target[:, ::2] = 5, 5
    elif case == "wide_labels":
        target[:, ::7] = k + 3
    got = intersection_and_union(pred, target, k, ignore)
    want = _bincount_iou(pred, target, k, ignore)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    if case == "all_ignored":
        assert all(float(a.sum()) == 0 for a in got)


def _window_tables_with_host_copies(k, xyz, new_xyz, valid=None):
    """``window_tables`` as it was, with its two host tensors copied up."""
    b, n, _ = xyz.shape
    dev = xyz.device
    gxy, gz = window_grid(n, k)
    cells = gxy * gxy * gz
    col = torch.arange(n, device=dev)
    ok = torch.ones((b, n), dtype=torch.bool, device=dev) if valid is None else (
        col[None, :] < valid.to(dev)[:, None]
    )
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.where(ok[..., None], xyz, inf).amin(dim=1)
    hi = torch.where(ok[..., None], xyz, -inf).amax(dim=1)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    shape = torch.tensor([gxy, gxy, gz], dtype=torch.float32, device=dev)
    cs = torch.clamp(hi - lo, min=1e-6) / shape
    cmax = (shape - 1).to(torch.int64)

    def cell_ids(p):
        c = torch.floor((p - lo[:, None]) / cs[:, None]).to(torch.int64)
        c = torch.minimum(torch.clamp(c, min=0), cmax)
        return (c[..., 0] * gxy + c[..., 1]) * gz + c[..., 2]

    pid = torch.where(ok, cell_ids(xyz), cells)
    pid_sorted, order = torch.sort(pid, dim=1, stable=True)
    bounds = torch.arange(cells + 1, device=dev).expand(b, -1).contiguous()
    starts = torch.searchsorted(pid_sorted, bounds).to(torch.int32)
    order32 = order.to(torch.int32)
    pts = torch.cat(
        [torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)),
         order32.view(torch.float32)[..., None]],
        dim=-1,
    ).contiguous()
    qorder = torch.sort(cell_ids(new_xyz), dim=1, stable=True).indices.to(torch.int32)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    return dict(pts=pts, starts=starts, qorder=qorder.contiguous(), lo=lo.contiguous(),
                cs=cs.contiguous(), slack=(scale * _SLACK).contiguous(), gxy=gxy, gz=gz)


@pytest.mark.parametrize("n,m,k,valid", [
    (20000, 20000, 16, None),            # the smallest grid past the window's floor
    (20000, 5000, 32, [20000, 14321]),   # valid < N
    (80000, 20000, 9, [80000, 61234]),   # the widest grid
    (3000, 700, 3, [2999, 1]),           # a one-point cloud
    (4096, 1024, 16, [0, 4096]),         # an empty cloud
])
def test_window_tables_equal_the_host_copy_form(n, m, k, valid):
    """Every table bit-equal to the form with the host tensors copied up,
    at grids from 4 x 4 x 2 to 32 x 32 x 12 cells, with padded and empty
    clouds."""
    g = torch.Generator().manual_seed(n + k)
    xyz = torch.rand(2, n, 3, generator=g) * torch.tensor([8.0, 6.0, 3.0]) - 2.0
    new_xyz = xyz[:, torch.randperm(n, generator=g)[:m]]
    v = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    got = window_tables(k, xyz, new_xyz, v)
    want = _window_tables_with_host_copies(k, xyz, new_xyz, v)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
        else:
            assert got[key] == w, key


def test_make_adamw_is_capturable_only_for_cuda_parameters_outside_a_process_group(
        monkeypatch):
    """The rule ``make_adam`` follows: capturable for CUDA parameters with
    no process group; CPU parameters or a process group keep torch's
    host-corrected AdamW, and ``make_sgd`` is never capturable."""
    on_card = [types.SimpleNamespace(is_cuda=True)] * 2
    assert optim._capturable(on_card)
    assert not optim._capturable([])
    assert not optim._capturable(on_card + [types.SimpleNamespace(is_cuda=False)])
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    assert not optim._capturable(on_card)
    monkeypatch.undo()

    params = [torch.nn.Parameter(torch.randn(5, 4, generator=torch.Generator().manual_seed(i)))
              for i in range(2)]
    opt = optim.make_adamw(params, 6e-3, 1e-2)
    assert not opt.param_groups[0]["capturable"]
    assert not optim.make_sgd(params, 0.1).param_groups[0].get("capturable", False)
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ref = torch.optim.AdamW(twins, lr=6e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    g = torch.Generator().manual_seed(7)
    for _ in range(4):
        grads = [torch.randn(p.shape, generator=g) for p in params]
        for o, ps in ((opt, params), (ref, twins)):
            for p, gr in zip(ps, grads):
                p.grad = gr.clone()
            o.step()
    assert all(torch.equal(p, q) for p, q in zip(params, twins))


SYNC_CELLS = {  # name -> SegConfig fields beyond the model's name
    "repsurf.repsurf_umb_ssg": {},
    "pointtransformer.pointtransformer": {},
    "pointnext.pointnext_xl": {"in_channel": 4, "num_sector": 1, "label_smoothing": 0.2},
}


def _card_batch(card, seed, n=20000):
    """Two clouds of ``n`` points on the card (past the window kNN's floor
    of 16,384, so the window tables, the window and re-solve kernels and
    sectorized FPS run), the second padded, every eleventh label
    ignored."""
    g = torch.Generator().manual_seed(seed)
    label = torch.randint(0, 13, (2, n), generator=g)
    label[:, ::11] = 255
    batch = {"coord": (torch.rand(2, n, 3, generator=g) * torch.tensor([6.0, 5.0, 3.0])),
             "feat": torch.rand(2, n, 3, generator=g), "label": label,
             "valid": torch.tensor([n, n - 3001], dtype=torch.int32)}
    return {k: v.to(card) for k, v in batch.items()}


def _card_step_inputs(name, card):
    """The seg recipe's model, optimizer and generator on the card, a batch
    and class weights."""
    from repsurf_torch.train import train_seg as tts

    cfg = tts.SegConfig(model=name, **SYNC_CELLS[name])
    model = tts.build_model(cfg, generator=torch.Generator().manual_seed(0)).to(card)
    opt = tts.make_optimizer(model, cfg)
    assert opt.param_groups[0]["capturable"]
    weight = torch.rand(13, generator=torch.Generator().manual_seed(9)).to(card) + 0.5
    return cfg, model, opt, _card_batch(card, 1), weight, torch.Generator(card).manual_seed(2)


@pytest.mark.card
@pytest.mark.parametrize("name", list(SYNC_CELLS))
def test_seg_step_makes_no_host_sync(card, name):
    """One eager seg step at the recipe's widths under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside the
    step raises, where under a graph it would only lose the capture."""
    from repsurf_torch.train import train_seg as tts

    cfg, model, opt, batch, weight, gen = _card_step_inputs(name, card)
    tts.eager_step(model, opt, batch, weight, cfg, generator=gen)  # builds, allocates
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, counts = tts.eager_step(model, opt, batch, weight, cfg, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss).item()
    assert float(counts[2].sum()) == float((batch["label"] != 255).sum())


@pytest.mark.card
@pytest.mark.parametrize("name", list(SYNC_CELLS))
def test_seg_step_is_captured_and_replayed(card, name):
    """``train_step`` on the card over four batches: one eager step, one
    capture, replays, no warning of a failed capture, each replay's own
    loss, and the graph's run as near to an eager run as two eager runs
    are to each other.  Two eager runs part from the second step (the
    backward's scatter-adds are atomic, so their sums' order varies), so
    the graph is held to that gap: a batch, rate or step count kept from
    the capture would part it by far more.  The spans the capture timed
    read after a replay."""
    import copy
    import warnings

    from repsurf_torch.train import step_graph
    from repsurf_torch.train import train_seg as tts

    cfg, model, _, _, weight, _ = _card_step_inputs(name, card)
    batches = [_card_batch(card, seed) for seed in (1, 3, 4, 5)]

    def train(step):
        m = copy.deepcopy(model)
        opt = tts.make_optimizer(m, cfg)
        gen = torch.Generator(card).manual_seed(2)
        losses = [step(m, opt, b, weight, cfg, generator=gen)[0] for b in batches]
        return losses, [p.detach() for p in m.parameters()]

    def gaps(a, b):
        (la, pa), (lb, pb) = a, b
        return (max(abs(float(x) - float(y)) for x, y in zip(la, lb)),
                max(float((x - y).abs().max()) for x, y in zip(pa, pb)))

    before = dict(step_graph.counts)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        graph = train(tts.train_step)
    assert {k: v - before[k] for k, v in step_graph.counts.items()} == {
        "captures": 1, "replays": 3, "eager": 1}
    secs = step_graph.span_seconds()
    assert secs["train.step"] > secs["train.forward"] + secs["train.backward"] > 0
    eager, again = train(tts.eager_step), train(tts.eager_step)
    values = [float(x) for x in graph[0]]
    assert all(torch.isfinite(x) for x in graph[0]) and len(set(values)) == len(values)
    floor_loss, floor_param = gaps(eager, again)
    loss_gap, param_gap = gaps(graph, eager)
    print(f"{name}: graph vs eager loss {loss_gap:.3e}, param {param_gap:.3e}; eager vs eager "
          f"loss {floor_loss:.3e}, param {floor_param:.3e}; spans {secs}")
    assert loss_gap <= 4 * floor_loss + 1e-4
    assert param_gap <= 4 * floor_param + 1e-3
