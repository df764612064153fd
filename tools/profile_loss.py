"""Count the serving profile windows that lose device records, with or
without phase 3's flash-backward checks before the serving paths.

Runs ``chip_smoke.py`` on the paths given, with every app's request
profiled N times (the first N - 1 windows of an app are always taken
again), and prints one ``EXP`` line a window and a total.  ``nobwd``
skips ``check_flash_backward``; ``bwd`` keeps it.  Needs the card; run
from the repo root:

    python3 tools/profile_loss.py nobwd 5 serve,frontends
    python3 tools/profile_loss.py bwd 5 serve,frontends
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(0, os.getcwd())
import chip_smoke as C  # noqa: E402

mode, n_windows, paths = sys.argv[1], int(sys.argv[2]), sys.argv[3]
seen = {"n": 0, "lost": 0}
orig_lost = C.lost_records


def lost_records(spans, n_calls):
    r = orig_lost(spans, n_calls)
    seen["n"] += 1
    seen["lost"] += r is not None
    print(f"EXP {mode} window {seen['n']}: "
          f"{'LOST ' + r if r else 'complete'}", flush=True)
    if seen["n"] % n_windows == 0:
        return None
    return r or f"window {seen['n']} complete, taken again"


C.lost_records = lost_records
C.PROFILE_TRIES = n_windows
if mode == "nobwd":
    C.check_flash_backward = lambda *a: 0.0
orig_run_serve = C.run_serve


def run_serve(mods, dev, path, tiny, n_requests=8):
    print(f"EXP {mode} {path}: reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB before the path",
          flush=True)
    return orig_run_serve(mods, dev, path, tiny, n_requests)


C.run_serve = run_serve
sys.argv = ["chip_smoke.py", "--paths", paths]
rc = C.main()
print(f"EXP {mode} {paths}: {seen['lost']} of {seen['n']} windows lost "
      f"records; rc {rc}", flush=True)
sys.exit(rc)
