"""Probe: the row-grouping kernel's (ball_group_kernel) and the
ball-feature kernel's device times (torch.profiler) at the SA1 and SA2
shapes of repsurf_ssg_umb, in the tree TREE.  With "variant", also a build
of TREE's csrc/ball_group.cu with the row kernel's output walk removed
(the walk loop of the one-warp-a-query row kernel that preceded
ball_body), which splits that kernel's time into selection and walk.

Usage, on a machine with a GPU:
    python3 repsurf_torch/probes/ball_rows.py TREE [variant]"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

tree = Path(sys.argv[1]).resolve()
variant = len(sys.argv) > 2 and sys.argv[2] == "variant"
sys.path.insert(0, str(tree))
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

cs.phase_card()
from repsurf_torch.ops.kernels import build  # noqa: E402

path, secs = build.build()
lib = build.library()
rep = build.resources(build.report_path().read_text())
for name, v in rep.items():
    if "ball" in name:
        print("ptxas", name, v)
from repsurf_torch.data.scanobjectnn import SyntheticClouds  # noqa: E402
from repsurf_torch.models import get_model  # noqa: E402
from repsurf_torch.ops.gather import index_points  # noqa: E402
from repsurf_torch.ops.kernels import ball_group as BG  # noqa: E402
from repsurf_torch.ops.kernels.fps import fps  # noqa: E402

dev = torch.device("cuda", 0)
with torch.inference_mode():
    raw = torch.from_numpy(SyntheticClouds(n_samples=64, seed=1).data).to(dev)
    _, xyz1 = fps(raw, 1024, return_xyz=True)
    idx2, xyz2 = fps(xyz1, 512, return_xyz=True)
    _, xyz3 = fps(xyz2, 128, return_xyz=True)
    model = get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    normal1 = model.surface_constructor(xyz1)
    normal2 = index_points(normal1, idx2)
    feat2 = torch.randn((64, 512, 128), generator=torch.Generator(dev).manual_seed(1), device=dev)

vlib = None
if variant:
    src = (tree / "repsurf_torch/csrc/ball_group.cu").read_text()
    old = "for (int e = lane; e < nsample * c; e += 32) {"
    assert old in src
    src = src.replace(old, "for (int e = lane; e < 0; e += 32) {")
    work = tree / "build" / "variant"
    work.mkdir(parents=True, exist_ok=True)
    (work / "ball_group.cu").write_text(src)
    (work / "knn_topk.cuh").write_text((tree / "repsurf_torch/csrc/knn_topk.cuh").read_text())
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          str(work / "libv.so"), str(work / "ball_group.cu")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    vlib = ctypes.CDLL(str(work / "libv.so"))
    vlib.repsurf_ball_group.restype = ctypes.c_int
    vlib.repsurf_ball_group.argtypes = build._SIGNATURES["repsurf_ball_group"][1]

sa = ((0.2, 32, xyz1, xyz2, [xyz1, normal1]), (0.4, 64, xyz2, xyz3, [xyz2, normal2, feat2]))
with torch.no_grad():
    for radius, s, xyz, q, tensors in sa:
        tcat = torch.cat(tensors, -1).contiguous()
        b, n, c = tcat.shape
        m = q.shape[1]
        tag = f"[{b}x{n}->{m},S={s},C={c}]"
        out = BG.ball_group_channels(radius, s, xyz, q, tcat)
        ref = BG.ball_group_channels_plain(radius, s, xyz, q, tcat)
        torch.cuda.synchronize()
        eq = torch.equal(out, ref)
        fn = lambda: BG.ball_group_channels(radius, s, xyz, q, tcat)  # noqa: E731
        ev = cs.median_ms(fn)
        split = cs.device_split(fn, {"rows": "ball_group_kernel"})
        line = (f"rows{tag}: bit-equal {eq}, events {ev:.4f} ms, device kernel "
                f"{split['rows']:.4f} ms other {split['other']:.4f}")
        if vlib is not None:
            sel = torch.empty((b, m, s), dtype=torch.int32, device=dev)
            o2 = torch.empty((b, m, s, c), device=dev)

            def floor():
                st = vlib.repsurf_ball_group(xyz.data_ptr(), q.data_ptr(), tcat.data_ptr(), None,
                                             b, n, m, c, s, BG._radius2(radius), o2.data_ptr(),
                                             sel.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert st == 0
            floor()
            torch.cuda.synchronize()
            want = BG.ball_query(radius, s, xyz, q).to(torch.int32)
            line += (f"; no-walk variant (selection + sel) device "
                     f"{cs.device_ms(floor):.4f} ms, sel equal {torch.equal(sel, want)}")
        print(line)
        ffn = lambda: BG.ball_group_feature(radius, s, xyz, q, tensors, return_polar=True)  # noqa: E731
        fs = cs.device_split(ffn, {"kernel": "ball_feature_kernel"})
        print(f"feature{tag}: device kernel {fs['kernel']:.4f} ms other {fs['other']:.4f}")
        if hasattr(BG, "ball_group_select_floor"):
            sfn = lambda: BG.ball_group_select_floor(radius, s, xyz, q, c)  # noqa: E731
            print(f"select floor{tag}: device {cs.device_ms(sfn):.4f} ms")
