"""Profile the 1024-lane AAC-LC v4 device step and reduce the trace.

    python benchmarks/trace_aac_step.py [--batches 8] [--out DIR]
    python benchmarks/trace_aac_step.py --reduce DIR   # an existing trace

Builds the same batches as ``bench.py`` (corpus clip, 1024 lanes, lane
i at AU (t + i) mod n), compiles and warms the step, times the loop of
``--batches`` steps once without the profiler, then records a
``jax.profiler`` trace of the same loop and reduces the device events
of that trace to:

- device busy time per batch and the idle share, both of the traced
  window (1 - union of kernel intervals / window) and of the
  unprofiled loop's wall (1 - busy / unprofiled wall): the profiler
  slows the launch loop, so the traced share is an upper bound;
- the IMDCT matmul kernels' time per batch and their share of the
  step (the step's only matrix products: GEMM kernels);
- the spectral entropy scan: the kernels launched once per scan
  iteration (launch count = batches x scan length), their time per
  batch and per iteration;
- the top kernels by total time.

Prints the reduction as one JSON line and writes it beside the trace.
Needs a GPU to record; ``--reduce`` works anywhere.
"""
import argparse
import glob
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _stats(ev) -> dict:
    out = {}
    for item in ev.stats:
        try:
            k, v = item
        except (TypeError, ValueError):
            continue
        out[str(k)] = v
    return out


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce_trace(path: str, batches: int) -> dict:
    """Reduce the device events of an ``.xplane.pb`` trace.

    XLA launches most of the step as CUDA graphs (command buffers); a
    kernel event names its kernel and carries its graph's id, and one
    graph launch shares one correlation id.  The scan body is the graph
    launched about ``batches x scan_steps`` times."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    kernels = defaultdict(lambda: [0, 0])  # kernel name -> [count, ns]
    # graph id -> [launch ids, ns, kernel count]
    graphs = defaultdict(lambda: [set(), 0, 0])
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = _stats(ev)
                if "memcpy_details" in st:
                    continue  # copies, not kernels
                kernels[ev.name][0] += 1
                kernels[ev.name][1] += ev.duration_ns
                gid = st.get("cuda_graph_id")
                if gid is not None:
                    graphs[gid][0].add(st.get("correlation_id"))
                    graphs[gid][1] += ev.duration_ns
                    graphs[gid][2] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError(f"no GPU kernel events in {path}")
    window = max(b for _, b in intervals) - min(a for a, _ in intervals)
    busy = _union_ns(intervals)
    total = sum(t for _, t in kernels.values())
    gemm = sum(t for n, (_, t) in kernels.items()
               if any(k in n.lower() for k in ("gemm", "xmma", "cutlass")))
    launches, body_ns, body_kernels = max(
        graphs.values(), key=lambda g: len(g[0]))
    iterations = len(launches) / batches
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "window_ms": window / 1e6,
        "window_ms_per_batch": window / batches / 1e6,
        "device_busy_ms_per_batch": busy / batches / 1e6,
        "idle_share": 1.0 - busy / window,
        "kernels_per_batch": sum(c for c, _ in kernels.values()) / batches,
        "kernel_ms_per_batch": total / batches / 1e6,
        "imdct_gemm_ms_per_batch": gemm / batches / 1e6,
        "imdct_gemm_share_of_kernels": gemm / total,
        "scan_body_launches_per_batch": iterations,
        "scan_body_kernels_per_launch": body_kernels / len(launches),
        "scan_ms_per_batch": body_ns / batches / 1e6,
        "scan_us_per_iteration": body_ns / (batches * iterations) / 1e3,
        "scan_share_of_kernels": body_ns / total,
        "top_kernels_ms": [(n, c, t / 1e6) for n, (c, t) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "trace_aac"))
    ap.add_argument("--reduce", metavar="DIR",
                    help="reduce an existing trace directory")
    args = ap.parse_args()

    if args.reduce:
        out = Path(args.reduce)
        batches = json.loads((out / "trace_meta.json").read_text())["batches"]
    else:
        import jax

        if jax.default_backend() != "gpu":
            print("trace_aac_step: needs a GPU to record", file=sys.stderr)
            return 2
        import bench
        from soundkit_tpu.utils.backend import gpu_card

        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        parse, step, scan_steps, _ = bench.setup(args.batches)
        bufs = [parse(t)[0] for t in range(args.batches)]
        saved, prev = bench.init_state()
        for buf in bufs[:2]:  # compile + warm
            pcm, saved, prev = step(buf, prev, saved, scan_steps)
        pcm.block_until_ready()
        batches = args.batches
        walls = []
        for traced in (False, True):
            if traced:
                jax.profiler.start_trace(str(out))
            t0 = time.perf_counter()
            for buf in bufs:
                pcm, saved, prev = step(buf, prev, saved, scan_steps)
            pcm.block_until_ready()
            walls.append((time.perf_counter() - t0) / batches * 1e3)
        jax.profiler.stop_trace()
        (out / "trace_meta.json").write_text(json.dumps(
            {"batches": batches, "scan_steps": scan_steps,
             "unprofiled_wall_ms_per_batch": walls[0],
             "traced_wall_ms_per_batch": walls[1],
             "card": gpu_card()}))
    path = sorted(glob.glob(str(out / "**" / "*.xplane.pb"),
                            recursive=True))[-1]
    summary = reduce_trace(path, batches)
    summary.update(json.loads((out / "trace_meta.json").read_text()))
    if "unprofiled_wall_ms_per_batch" in summary:
        summary["idle_share_unprofiled"] = 1.0 - (
            summary["device_busy_ms_per_batch"]
            / summary["unprofiled_wall_ms_per_batch"])
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
