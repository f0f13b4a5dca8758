"""Watch torch.profiler's device readings over a long process, on the card:

    python3 pipegcn_tpu_torch/tools/profiler_window.py [--minutes 8] \\
        [--every 30] [--pad 0.05]

Every ``--every`` seconds, after keeping the card busy with f32 matmuls
in between (as a training phase does), it profiles 20 launches of a tiny
kernel twice: once with the window closed right after the last launch
has finished, once with the window held open ``--pad`` seconds before
the first launch and after the last. For each sample it prints one JSON
line: the process's age in seconds, the kernels each session saw (of
20), and the offset in microseconds between the first launch's host
call and its kernel's start as the padded session reads them (a few
microseconds on an idle card, on clocks that agree). The last line sums
the samples up."""
import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def session(x, pad):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(20):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad)
    ev = prof.events()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    calls = [e for e in ev if e.device_type == DeviceType.CPU
             and e.name == "aten::add_"]
    offset = (min(e.time_range.start for e in kernels)
              - min(e.time_range.start for e in calls)
              if kernels and calls else None)
    return len(kernels), offset


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=8.0)
    ap.add_argument("--every", type=float, default=30.0)
    ap.add_argument("--pad", type=float, default=0.05)
    args = ap.parse_args()
    t0 = time.monotonic()
    x = torch.zeros(1, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    samples = []
    while time.monotonic() - t0 < args.minutes * 60:
        busy = time.monotonic()
        while time.monotonic() - busy < args.every:
            for _ in range(50):
                a = torch.tanh(a @ a)
            torch.cuda.synchronize()
        bare, _ = session(x, 0.0)
        padded, offset = session(x, args.pad)
        s = {"age_s": time.monotonic() - t0, "bare_seen": bare,
             "padded_seen": padded, "offset_us": offset}
        samples.append(s)
        print(json.dumps(s), flush=True)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "samples": len(samples), "pad_s": args.pad,
        "bare_empty": sum(s["bare_seen"] < 20 for s in samples),
        "padded_empty": sum(s["padded_seen"] < 20 for s in samples),
        "offset_us_first_last": [samples[0]["offset_us"],
                                 samples[-1]["offset_us"]]
        if samples else None}))


if __name__ == "__main__":
    main()
