"""Offer an open-loop serving cell's traffic at several rates to find the
highest rate the port sustains (its queue does not grow through the
window). Each rate is one run of the cell (``run.execute``) with the mix's
``rate_per_s`` set to it. The benchmark's runs do not run this; a cell's
mix then states a fixed rate below what it finds.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 3 4 5 6

One JSON line per rate: requests due in the window and finished, the queue
and the busy rows when the window closed, the TTFT's 95th percentile and
output tokens per second (the cell's own readers), whether the run was
correct.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch

    from portbench import run, spec

    read = {n: spec.metric_reader(n).read for n in ("ttft_p95_ms.host", "serve_tokens_per_s")}

    run.cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for rate in a.rates:
        result, r = run.execute(a.workload, a.seed, a.seconds, False, device,
                                t_start=time.perf_counter(), mix_update={"rate_per_s": rate})
        print(json.dumps({
            "rate_per_s": rate, "due": r.attempted,
            "finished": sum(1 for s in r.served.values() if s.done),
            "queued_at_end": r.notes["queued_at_end"], "active_at_end": r.notes["active_at_end"],
            **{n: f(r) for n, f in read.items()}, "correct": result["correct"]}), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
