#!/usr/bin/env python3
"""Build report of the ray-march and fusion kernels, and the ray march's
warp mapping and tail share, on one NVIDIA card.

    python3 tools/kernel_probe.py [--parent DIR]

Builds csrc/raycast.cu and csrc/fusion.cu (and, with --parent, the same
files of another checkout, e.g. the parent commit unpacked by git archive)
with the package's nvcc flags, and reports per kernel function the
registers, stack and spills (ptxas -v), the SASS instruction count, the
integer-division signature in it (on sm_90 a 32-bit division by a runtime
value is I2F.RP + MUFU.RCP for the divisor's reciprocal, then IABS and
IMAD.HI.U32 for each quotient), and the occupancy the registers allow. The
SASS listings go beside the libraries under build/torch_kernels/probe/.
Then it fuses chip_smoke.py's 48-frame scene (512^3, 640x480) and times, as
CUDA-event medians of 10 launches with the L2 flushed and the card spun
(chip_smoke's Timer), on pose 24's 307,200 rays, each checked bit-equal to
march_plain:

  * the ray march as march() launches it (8x4 pixel tiles a warp) and with
    a warp on 32 pixels of one row (tile_width 0, the mapping for rays that
    do not form an image);
  * a scratch copy of raycast.cu without the refinement and normals (the
    tail's share of the kernel; tail_cut names the one line it drops);
  * the --parent tree's ray-march kernel on the same rays.

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
    """{function: {registers, stack, spill_stores, spill_loads}} from -Xptxas -v."""
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
    return rep


def occupancy(registers: int, threads: int) -> float:
    """Resident warps per SM over 64 that the registers allow (256-register
    allocation units per warp, whole blocks, at most 32 blocks an SM)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps_per_block = threads // 32
    blocks = min(32, 65536 // (per_warp * warps_per_block), 64 // warps_per_block)
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
            row["occupancy"] = occupancy(row["registers"], t)
        table[fn] = row
        log(f"{name}: {fn}: { {k: v for k, v in row.items() if k != 'opcodes'} }")
    return table


TAIL_CALL = "vol.tail(cache, ox, oy, oz, dx, dy, dz, t, i, n_rays, out);"


def tail_cut(raycast_src: str) -> str:
    """raycast.cu without the refinement and normals of found rays."""
    if raycast_src.count(TAIL_CALL) != 1:
        raise RuntimeError(f"tail_cut: {TAIL_CALL!r} not found once in raycast.cu")
    return raycast_src.replace(TAIL_CALL, "")


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
    fus_src = (csrc / "fusion.cu").read_text()
    sources = {"raycast": ray_src, "raycast_no_tail": tail_cut(ray_src), "fusion": fus_src}
    if args.parent:
        pc = args.parent / "cpu_tsdf_tpu_torch" / "csrc"
        sources["parent_raycast"] = (pc / "raycast.cu").read_text()
        sources["parent_fusion"] = (pc / "fusion.cu").read_text()
    built = build_all(sources)
    report = {"card": smi, "sass": {}, "raycast_ms": {}}
    threads = {"raycast_kernel": 128, "fuse_kernel": 128}
    for name, (lib, text) in built.items():
        t = dict(threads)
        if name == "parent_fusion":
            t["fuse_kernel"] = 512
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

    text = json.dumps(report)
    (PROBE_DIR / "kernel_probe.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
