"""Run one cell of ``BENCHMARK.json`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, weights, warm-up of the cell's shapes), then ``--seconds``
of measured work, then the check of what the window produced against the
plain fp32 reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, ``breakdown`` (``--trace 1``) and ``checks``, each compared
number beside its limit. Without the cards the cell asks for, or with JAX
or the JAX package loaded, it exits with code 2 and prints no result.

``--control`` puts the control in the program's place (the reference with
every matmul in fp8) and judges it as it judges the program; ``--rate`` sets an
open loop's arrival rate; ``--fault`` plants one of ``lib/faults.py``'s
faults under the timed path. They serve the setting of limits and rates, and
the benchmark's runs use none of them."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches live in the checkout, at fixed paths
_CACHE = CHECKOUT / "perfbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(CHECKOUT))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from perfbench.lib.harness import (
        HarnessError, checks_text, forbidden_modules, load_cell, load_driver, load_reader,
        result_line)

    try:
        cell = load_cell(args.workload)
        import torch

        from perfbench.lib.device import device_report, require_chips
        require_chips(cell.chips)
    except (HarnessError, OSError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    from perfbench.lib.runctx import RunCtx
    from perfbench.lib.spans import Spans

    print(f"perfbench: imports done at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    ctx = RunCtx(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                 device=torch.device("cuda", 0), spans=Spans(), control=args.control,
                 rate=args.rate, t_start=T_START)
    from perfbench.lib.faults import planted

    with planted(args.fault):
        outcome = load_driver(cell.traffic).run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 2
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics, breakdown = {}, None
    if args.trace:
        run = outcome.trace
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(run, outcome.info)
            if value is not None:
                metrics[m["name"]] = (value, units[m["name"]])
        breakdown = run.breakdown()
    else:
        e2e = dict(outcome.e2e, setup_s=outcome.setup_end - T_START)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = (e2e[m["name"]], units[m["name"]])
    device = device_report(cell.chips, outcome.peak_bytes)
    if args.trace:
        device.update(busy_s=run.busy_s, window_s=run.window_s)
    correct = bool(outcome.checks) and all(c.ok for c in outcome.checks)
    print(checks_text(outcome.checks), file=sys.stderr)
    print(result_line(correct, outcome.attempted, outcome.failed, metrics, device,
                      outcome.checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
