#!/usr/bin/env python3
"""Build report of the port's kernels, the ray march's warp mapping and
tail share, and the MC emission's store design, on one NVIDIA card.

    python3 tools/kernel_probe.py [--parent DIR]

Builds csrc/raycast.cu, fusion.cu, mc_corner_halo.cu and mc_emit.cu (and,
with --parent, the kernel sources of another checkout, e.g. the parent
commit unpacked by git archive) with the package's nvcc flags, and reports
per kernel function the registers, stack, spills and shared memory (ptxas
-v), the SASS instruction count, the integer-division signature in it (on
sm_90 a 32-bit division by a runtime value is I2F.RP + MUFU.RCP for the
divisor's reciprocal, then IABS and IMAD.HI.U32 for each quotient), and the
occupancy the registers and shared memory allow. The SASS listings go
beside the libraries under build/torch_kernels/probe/. Then it fuses
chip_smoke.py's 48-frame scene (512^3, 640x480) and times, as CUDA-event
medians of 10 launches with the L2 flushed and the card spun (chip_smoke's
Timer):

  * on pose 24's 307,200 rays, each checked bit-equal to march_plain: the
    ray march as march() launches it (8x4 pixel tiles a warp) and with a
    warp on 32 pixels of one row (tile_width 0, the mapping for rays that
    do not form an image); a scratch copy of raycast.cu without the
    refinement and normals (the tail's share of the kernel; tail_cut names
    the one line it drops); the --parent tree's ray-march kernel;
  * on the extraction's candidates, each checked equal to the shipped
    kernel: the corner halo at 128 (shipped), 64, 256 and 512 threads a
    block and the emission at 128 (shipped) and 64 (block_width sets the
    one kThreads line), and a scratch copy of the emission that stores each
    triangle from its thread instead of staging a chunk's triangles in
    shared memory for coalesced stores (direct_store names the three
    passages it replaces);
  * with --parent, the parent's triangle compaction on its real triangle
    mask: the pack-left kernel alone, pack_left_rows + _compact_from_loc,
    and torch.nonzero over the same mask (the one PyTorch call that
    computes the same flat indices, checked equal).

Prints one JSON object on stdout and writes it to
build/torch_kernels/probe/kernel_probe.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROBE_DIR = ROOT / "build" / "torch_kernels" / "probe"
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def log(msg: str) -> None:
    print(f"[kernel_probe] {msg}", file=sys.stderr, flush=True)


def build_all(sources: dict) -> dict:
    """Compile {name: source text} with the package's flags, one nvcc each,
    all at once; returns {name: (library path, nvcc log)}."""
    from cpu_tsdf_tpu_torch import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = PROBE_DIR / f"{name}.cu"
        src.write_text(text)
        lib = PROBE_DIR / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        out[name] = (lib, text)
    return out


def ptxas_report(text: str) -> dict:
    """{function: {registers, smem, stack, spill_stores, spill_loads}} from
    -Xptxas -v."""
    rep, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            rep[fn] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            rep[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rep[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rep[fn]["smem"] = int(m.group(1)) if m else 0
    return rep


def occupancy(registers: int, threads: int, smem: int = 0) -> float:
    """Resident warps per SM over 64 that the registers and shared memory
    allow (256-register allocation units per warp; 228 KB of shared memory
    an SM, 1 KB of it reserved per block; whole blocks, at most 32 an SM)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps_per_block = threads // 32
    blocks = min(32, 65536 // (per_warp * warps_per_block), 64 // warps_per_block,
                 233472 // (smem + 1024))
    return blocks * warps_per_block / 64


def sass_report(lib: Path) -> dict:
    """{function: {instructions, int_div, mufu_rcp, ldg, opcodes}} from
    cuobjdump -sass (also written beside the library as <lib>.sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    lib.with_suffix(".sass").write_text(text)
    rep, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            rep[fn] = {"instructions": 0, "i2f_rp": 0, "iabs": 0, "imad_hi_u32": 0,
                       "mufu_rcp": 0, "ldg": 0, "opcodes": {}}
            continue
        m = INSN.search(line)
        if m and fn:
            op = m.group(1)
            if op.startswith("NOP"):
                continue
            r = rep[fn]
            r["instructions"] += 1
            r["i2f_rp"] += op == "I2F.RP"
            r["iabs"] += op == "IABS"
            r["imad_hi_u32"] += op == "IMAD.HI.U32"
            r["mufu_rcp"] += op.startswith("MUFU.RCP")
            r["ldg"] += op.startswith("LDG")
            r["opcodes"][op] = r["opcodes"].get(op, 0) + 1
    return rep


def kernel_table(name: str, lib: Path, text: str, threads: dict) -> dict:
    sass, ptx = sass_report(lib), ptxas_report(text)
    table = {}
    for fn, r in sass.items():
        row = {**r, **ptx.get(fn, {})}
        t = next((n for key, n in threads.items() if key in fn), None)
        if "registers" in row and t:
            row["occupancy"] = occupancy(row["registers"], t, row.get("smem", 0))
        table[fn] = row
        log(f"{name}: {fn}: { {k: v for k, v in row.items() if k != 'opcodes'} }")
    return table


TAIL_CALL = "vol.tail(cache, ox, oy, oz, dx, dy, dz, t, i, n_rays, out);"


def tail_cut(raycast_src: str) -> str:
    """raycast.cu without the refinement and normals of found rays."""
    if raycast_src.count(TAIL_CALL) != 1:
        raise RuntimeError(f"tail_cut: {TAIL_CALL!r} not found once in raycast.cu")
    return raycast_src.replace(TAIL_CALL, "")


# The emission kernel's staged stores, and what a thread storing its own
# triangles puts in their place (direct_store).
STAGE_DECL = """  __shared__ float st_v[kStage * 9];
  __shared__ int st_c[kStage];
"""
STAGE_PUT = """        float* dst = st_v + (first + i) * 9;
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q] = out[q];
        st_c[first + i] = ref;
"""
DIRECT_PUT = """        float* dst = verts + (size_t)(base + first + i) * 9;
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q] = out[q];
        tri_cube[base + first + i] = ref;
"""
STAGE_OUT = """    __syncthreads();
    float* dv = verts + (size_t)base * 9;
    for (int f = t; f < total * 9; f += kThreads) dv[f] = st_v[f];
    for (int f = t; f < total; f += kThreads) tri_cube[base + f] = st_c[f];
"""


def direct_store(emit_src: str) -> str:
    """mc_emit.cu with each thread storing its triangles to device memory
    itself: no stage in shared memory and no copy-out."""
    for anchor in (STAGE_DECL, STAGE_PUT, STAGE_OUT):
        if emit_src.count(anchor) != 1:
            raise RuntimeError(f"direct_store: {anchor!r} not found once in mc_emit.cu")
    return (emit_src.replace(STAGE_DECL, "").replace(STAGE_PUT, DIRECT_PUT)
            .replace(STAGE_OUT, ""))


def block_width(src: str, threads: int) -> str:
    """A kernel source with its block width (``constexpr int kThreads``) set
    to ``threads``."""
    out, n = re.subn(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", src)
    if n != 1:
        raise RuntimeError("block_width: kThreads not defined once")
    return out


def load_parent(root: Path):
    """The parent checkout's port package, imported under another name (its
    modules import each other relatively, and build from their own csrc)."""
    import importlib
    import importlib.util

    init = root / "cpu_tsdf_tpu_torch" / "__init__.py"
    name = "parent_cpu_tsdf_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.marching_cubes")


HALO_WIDTHS = (128, 64, 256, 512)   # the first is the shipped block width
EMIT_WIDTHS = (128, 64)


def mc_sources(csrc: Path) -> dict:
    """The MC kernels as shipped, at the other block widths, and the
    emission with direct stores."""
    halo = (csrc / "mc_corner_halo.cu").read_text()
    emit = (csrc / "mc_emit.cu").read_text()
    out = {"mc_corner_halo": halo, "mc_emit": emit, "mc_emit_direct": direct_store(emit)}
    out.update({f"mc_corner_halo_{n}": block_width(halo, n) for n in HALO_WIDTHS[1:]})
    out.update({f"mc_emit_{n}": block_width(emit, n) for n in EMIT_WIDTHS[1:]})
    return out


def mc_probe(torch, vol, timer, built, parent) -> dict:
    """The corner halo at three block widths and the emission at two and
    with direct stores, on the extraction's candidates, each checked equal
    to the shipped kernel; with a parent, its triangle compaction against
    torch.nonzero."""
    from cpu_tsdf_tpu_torch import _build
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc

    cfg, dev = vol.config, vol.device
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = _build.stream_ptr(dev)
    cand = mc._candidate_slots(vol, 0.5)
    K = int(cand.shape[0])
    ref = mc.corner_halo(vol, cand, 0.5)
    count, cube, corners, ntri = ref
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n_tri, off = int(ends[-1]), ends - ntri
    ref_v, ref_t = mc.emit_triangles(vol, cand, count, cube, corners, off, n_tri)
    rep = {"bricks": K, "cubes": int(count.sum()), "triangles": n_tri, "halo_ms": {},
           "emit_ms": {}}

    outs = [torch.empty_like(x) for x in ref]
    for name in [n for n in built if n.startswith("mc_corner_halo")]:
        fn = ctypes.CDLL(str(built[name][0])).tsdf_corner_halo
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 8 + [f, f] + [p] * 5

        def run(fn=fn, name=name):
            _build.check(fn(vol.sdf.data_ptr(), vol.weight.data_ptr(), vol.brick_map.data_ptr(),
                            vol.coords.data_ptr(), cand.data_ptr(), K, vol.capacity,
                            *vol.bricks_per_axis, cfg.xres, cfg.yres, cfg.zres, 0.5,
                            cfg.max_dist_neg, *(o.data_ptr() for o in outs), stream), name)
        run()
        torch.cuda.synchronize()
        live = torch.arange(512, device=dev)[None] < count[:, None]
        equal = (all(torch.equal(a, b) for a, b in zip(outs[:2] + outs[3:], ref[:2] + ref[3:]))
                 and torch.equal(outs[2][live], corners[live]))
        rep["halo_ms"][name] = {"ms": timer.ms(run, spin=True), "equal": equal}
        log(f"corner halo {name}: {rep['halo_ms'][name]}")
        if not equal:
            raise AssertionError(f"{name} differs from corner_halo")

    grid = (ctypes.c_float * 7)(*cfg.cell_size, cfg.xsize / 2.0, cfg.ysize / 2.0,
                                cfg.zsize / 2.0, cfg.max_dist_neg)
    verts = torch.empty_like(ref_v)
    tri_cube = torch.empty_like(ref_t)
    for name in [n for n in built if n.startswith("mc_emit")]:
        fn = ctypes.CDLL(str(built[name][0])).tsdf_mc_emit
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 7 + [i, ctypes.POINTER(ctypes.c_float)] + [p] * 3

        def run(fn=fn, name=name):
            _build.check(fn(cand.data_ptr(), vol.coords.data_ptr(), count.data_ptr(),
                            cube.data_ptr(), corners.data_ptr(), off.data_ptr(),
                            vol.global_transform.data_ptr(), K, grid, verts.data_ptr(),
                            tri_cube.data_ptr(), stream), name)
        verts.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        equal = torch.equal(verts, ref_v) and torch.equal(tri_cube, ref_t)
        rep["emit_ms"][name] = {"ms": timer.ms(run, spin=True), "equal": equal}
        log(f"emission {name}: {rep['emit_ms'][name]}")
        if not equal:
            raise AssertionError(f"{name} differs from emit_triangles")
    if parent is None:
        return rep
    pcand = parent._candidate_slots(vol, 0.5)
    dk, okk, lk = parent.corner_halo(vol, pcand, 0.5)
    ids = parent._compact_from_loc(okk, lk)
    _, ntris = parent._case_rows(dk[ids] * cfg.max_dist_neg)
    tri = (torch.arange(parent.MAX_TRIS_PER_CUBE, device=dev)[None] < ntris[:, None]).reshape(-1)
    tri = torch.cat([tri, tri.new_zeros((-tri.shape[0]) % 512)]).to(torch.int32).reshape(-1, 512)
    sel = parent._compact_from_loc(tri, parent.pack_left_rows(tri))
    equal = torch.equal(sel, torch.nonzero(tri.reshape(-1)).squeeze(1))
    rep["parent_compaction"] = {
        "rows": int(tri.shape[0]), "triangles": int(sel.shape[0]), "nonzero_equal": equal,
        "pack_left_ms": timer.ms(lambda: parent.pack_left_rows(tri), spin=True),
        "pack_left_compact_from_loc_ms": timer.ms(
            lambda: parent._compact_from_loc(tri, parent.pack_left_rows(tri)), spin=True),
        "nonzero_ms": timer.ms(lambda: torch.nonzero(tri.reshape(-1)), spin=True)}
    log(f"parent triangle compaction: {rep['parent_compaction']}")
    if not equal:
        raise AssertionError("the parent's compaction differs from torch.nonzero")
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another checkout to build and time beside")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    import chip_smoke as cs
    import cpu_tsdf_tpu_torch as T
    from cpu_tsdf_tpu_torch import _build, pack_render
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays

    smi = cs.nvidia_smi_line()
    log(f"card: {smi}")
    csrc = ROOT / "cpu_tsdf_tpu_torch" / "csrc"
    ray_src = (csrc / "raycast.cu").read_text()
    sources = {"raycast": ray_src, "raycast_no_tail": tail_cut(ray_src),
               "fusion": (csrc / "fusion.cu").read_text(), **mc_sources(csrc)}
    parent = None
    if args.parent:
        pc = args.parent / "cpu_tsdf_tpu_torch" / "csrc"
        for name in ("raycast", "fusion", "mc_corner_halo", "pack_left"):
            sources[f"parent_{name}"] = (pc / f"{name}.cu").read_text()
        parent = load_parent(args.parent)
    built = build_all(sources)
    report = {"card": smi, "sass": {}, "raycast_ms": {}}
    threads = {"raycast_kernel": 128, "fuse_kernel": 128, "corner_halo_kernel": 128,
               "emit_kernel": 128, "pack_left_kernel": 256}
    for name, (lib, text) in built.items():
        t = dict(threads)
        if name == "parent_fusion":
            t["fuse_kernel"] = 512
        if name == "parent_mc_corner_halo":
            t["corner_halo_kernel"] = 512
        m = re.fullmatch(r"mc_(corner_halo|emit)_(\d+)", name)
        if m:
            t[m.group(1) + "_kernel"] = int(m.group(2))
        report["sass"][name] = kernel_table(name, lib, text, t)

    # ---- the scene: chip_smoke's main path ----
    dev = torch.device("cuda")
    cfg = T.TSDFConfig().with_updates(min_sensor_dist=0.3, integrate_color=True,
                                      color_mode="RGB")
    poses_h, depths_h, rgb_h = cs.orbit(cfg, 48)
    poses = torch.as_tensor(poses_h, device=dev)
    depths = torch.as_tensor(depths_h, device=dev)
    rgb = torch.as_tensor(rgb_h, device=dev)
    vol = T.make_brick_volume(cfg, 8, 1 << 15, device=dev)
    for i in range(48):
        T.integrate_bricks(vol, depths[i], poses[i], rgb, 1 << 12)
    torch.cuda.synchronize()
    timer = cs.Timer(torch, dev)

    # ---- ray march ----
    packed = pack_render(vol)
    origins, dirs = (t.contiguous() for t in camera_rays(cfg, poses[24]))
    N = origins.shape[0]
    plain = rk.march_plain(packed, origins, dirs)
    out = torch.empty((8, N), dtype=torch.float32, device=dev)
    stream = _build.stream_ptr(dev)
    W = cfg.image_width

    def shipped(lib_name, tile):
        fn = ctypes.CDLL(str(built[lib_name][0])).tsdf_raycast
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(rk.RaycastParams)] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        params = rk.raycast_params(packed, 512, tile)

        def run():
            _build.check(fn(ctypes.byref(params), packed.rd.data_ptr(),
                            packed.brick_map.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
                            N, out.data_ptr(), stream), lib_name)
        return run

    assert rk.tile_width(cfg, N) == W
    shapes = {
        "march (tile8x4)": lambda: rk.march(packed, origins, dirs),
        "row32": shipped("raycast", 0),
        "tile8x4": shipped("raycast", W),
    }
    if args.parent:
        fn = ctypes.CDLL(str(built["parent_raycast"][0])).tsdf_raycast
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(rk.RaycastParams)] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        pparams = rk.raycast_params(packed, 512)   # the parent reads the prefix it knows

        def parent_run():
            _build.check(fn(ctypes.byref(pparams), packed.rd.data_ptr(),
                            packed.brick_map.data_ptr(), origins.data_ptr(),
                            dirs.data_ptr(), N, out.data_ptr(), stream), "parent raycast")
        shapes["parent kernel"] = parent_run
    for name, run in shapes.items():
        out.fill_(float("nan"))
        res = run()
        torch.cuda.synchronize()
        equal = torch.equal(out if res is None else res, plain)
        ms = timer.ms(run, spin=True)
        report["raycast_ms"][name] = {"ms": ms, "bit_equal": equal}
        log(f"raycast {name}: {ms:.4f} ms, bit-equal {equal}")
        if not equal:
            raise AssertionError(f"raycast {name} differs from march_plain")
    for tile, tag in ((0, "row32"), (W, "tile8x4")):
        ms = timer.ms(shipped("raycast_no_tail", tile), spin=True)
        report["raycast_ms"][f"{tag}, refinement and normals cut off"] = {"ms": ms}
        log(f"raycast {tag} without refinement and normals: {ms:.4f} ms")
    nbytes, nops = rk.march_work(packed, origins, dirs)
    report["raycast_bound_ms"] = max(nbytes / cs.HBM_BYTES_PER_S, nops / cs.FP32_OPS_PER_S) * 1e3
    report["raycast_work"] = {"bytes": nbytes, "operations": nops,
                              "found": int(plain[1].sum()), "valid": int(plain[3].sum())}
    report["mc"] = mc_probe(torch, vol, timer, built, parent)

    text = json.dumps(report)
    (PROBE_DIR / "kernel_probe.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
