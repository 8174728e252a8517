"""Probe: the row-grouping and ball-feature kernels of two builds of
csrc/ball_group.cu, the parent's source and this tree's, timed by
torch.profiler device time in the same process at the SA1 and SA2 shapes
of repsurf_ssg_umb (seeded synthetic clouds), rounds interleaved so the
spread shows, each output checked bit-equal to its plain version.

Usage, from the root of the repo on a machine with a GPU:
    git show <parent>:repsurf_torch/csrc/ball_group.cu > build/parent_ball_group.cu
    python3 repsurf_torch/probes/ball_variants.py [rounds]"""
import ctypes
import subprocess
import sys
from pathlib import Path

tree = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(tree))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

cs.phase_card()
from repsurf_torch.data.scanobjectnn import SyntheticClouds  # noqa: E402
from repsurf_torch.models import get_model  # noqa: E402
from repsurf_torch.ops.gather import index_points  # noqa: E402
from repsurf_torch.ops.kernels import ball_group as BG  # noqa: E402
from repsurf_torch.ops.kernels import build  # noqa: E402
from repsurf_torch.ops.kernels.fps import fps  # noqa: E402

build.build()
VARIANTS = {"parent": "parent", "change": []}
src0 = (tree / "repsurf_torch/csrc/ball_group.cu").read_text()
work = tree / "build" / "variants"
work.mkdir(parents=True, exist_ok=True)
(work / "knn_topk.cuh").write_text((tree / "repsurf_torch/csrc/knn_topk.cuh").read_text())
procs = {}
for name, subs in VARIANTS.items():
    s = src0 if subs != "parent" else (tree / "build/parent_ball_group.cu").read_text()
    for old, new in ([] if subs == "parent" else subs):
        assert old in s, (name, old)
        s = s.replace(old, new)
    d = work / name.replace("+", "_")
    d.mkdir(exist_ok=True)
    (d / "ball_group.cu").write_text(s)
    (d / "knn_topk.cuh").write_text((tree / "repsurf_torch/csrc/knn_topk.cuh").read_text())
    procs[name] = (d, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
         str(d / "ball_group.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
libs = {}
for name, (d, proc) in procs.items():
    out, _ = proc.communicate()
    assert proc.returncode == 0, out
    res = build.resources(out)
    print(name, {k.split("ball_group_cu_")[-1][10:40]: v for k, v in res.items() if "ball_" in k
                 and "scatter" not in k})
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn in ("repsurf_ball_group", "repsurf_ball_feature"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = build._SIGNATURES[fn][1]
    libs[name] = lib

dev = torch.device("cuda", 0)
with torch.inference_mode():
    raw = torch.from_numpy(SyntheticClouds(n_samples=64, seed=1).data).to(dev)
    _, xyz1 = fps(raw, 1024, return_xyz=True)
    idx2, xyz2 = fps(xyz1, 512, return_xyz=True)
    _, xyz3 = fps(xyz2, 128, return_xyz=True)
    model = get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(0))
    normal1 = model.to(dev).eval().surface_constructor(xyz1)
    normal2 = index_points(normal1, idx2)
    feat2 = torch.randn((64, 512, 128), generator=torch.Generator(dev).manual_seed(1), device=dev)
sa = ((0.2, 32, xyz1, xyz2, [xyz1, normal1]), (0.4, 64, xyz2, xyz3, [xyz2, normal2, feat2]))
st = torch.cuda.current_stream().cuda_stream
with torch.no_grad():
    for radius, s, xyz, q, tensors in sa:
        tcat = torch.cat(tensors, -1).contiguous()
        b, n, c = tcat.shape
        m = q.shape[1]
        r2 = BG._radius2(radius)
        ref = BG.ball_group_channels_plain(radius, s, xyz, q, tcat)
        ppos, pfeat = BG.ball_group_feature_plain(radius, s, xyz, q, tensors, return_polar=True)
        out = torch.empty((b, m, s, c), device=dev)
        pos = torch.empty((b, m, s, 6), device=dev)
        feat = torch.empty((b, m, s, c - 3), device=dev)
        for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 2):  # interleaved: the spread
            for name, lib in libs.items():
                def rows(lib=lib):
                    assert lib.repsurf_ball_group(xyz.data_ptr(), q.data_ptr(), tcat.data_ptr(),
                                                  None, b, n, m, c, s, r2, out.data_ptr(), None,
                                                  st) == 0

                def feature(lib=lib):
                    assert lib.repsurf_ball_feature(xyz.data_ptr(), q.data_ptr(),
                                                    tcat.data_ptr(), None, b, n, m, c, s, r2, 1,
                                                    pos.data_ptr(), feat.data_ptr(), None,
                                                    st) == 0
                rows()
                feature()
                torch.cuda.synchronize()
                ok = torch.equal(out, ref) and torch.equal(feat, pfeat)
                print(f"[{b}x{n}->{m},S={s},C={c}] {name}: equal {ok}, rows device "
                      f"{cs.device_ms(rows):.4f} ms, feature device {cs.device_ms(feature):.4f} ms")
