"""A traced run of one cell with the program's own spans, for the card.

    python3 benchmark/spans.py --workload <name> --seed <n> --seconds <s>

The run is ``run.py --trace 1``'s, and prints its lines, with one JSON line
more before the last two: ``{"spans": ...}``. For the window it opens the
program's tracer as a run kept in memory (``obs.trace.open_run(None)``: no
file, no hashing), wraps each isolate in a program span ``isolate/<n>``, and
counts the bytes each isolate copies to the host through
``device.to_host``. After the window it puts each idle interval of the card,
and each copy, down to the innermost program span that covers it
(``lib/attribute.py``): ``idle_by_span``, ``copies_by_span`` and
``idle_named_share``; per isolate, the program's stage steps by command
beside the benchmark's stage seconds, and ``to_host_GB``; and
``probe_wait_s``, the program's wait on its device probe by the end of
set-up.

Against a program whose tracer has no in-memory run the line says so and
holds nothing else.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class ProgramSpans:
    """The hooks that put the program's tracer around the window: they
    stand in for ``instrument.start_profiler``, ``instrument.read_trace``
    and ``window.run_isolate`` while the run lasts."""

    def __init__(self):
        self.run = None
        self.supported = True
        self.probe_wait_s = None
        self.to_host = []
        self.result = None

    def install(self, window, instrument, run_module):
        real_start, real_read = instrument.start_profiler, instrument.read_trace
        real_isolate, real_finish = window.run_isolate, run_module.finish

        def start_profiler():
            from autocycler_tpu_torch.obs import trace
            from autocycler_tpu_torch.utils import timing

            self.probe_wait_s = timing.device_wait_seconds()
            prof = real_start()
            try:
                self.run = trace.open_run(None, name="benchmark-window")
            except TypeError:       # a tracer that needs a directory
                self.supported = False
            return prof

        def run_isolate(asm, out, config, device, instr):
            if self.run is None:
                return real_isolate(asm, out, config, device, instr)
            from autocycler_tpu_torch import device as program_device
            from autocycler_tpu_torch.obs import trace

            b0 = program_device.to_host_bytes()
            with trace.span(f"isolate/{len(self.to_host)}", cat="isolate"):
                real_isolate(asm, out, config, device, instr)
            self.to_host.append((program_device.to_host_bytes() - b0) / 1e9)

        def read_trace(prof, stage_calls, window_ns):
            out = real_read(prof, stage_calls, window_ns)
            if self.run is not None:
                self.result = self.summarise(prof, stage_calls, window_ns)
            return out

        def finish(*args, **kwargs):
            line = ({"supported": False} if not self.supported
                    else self.result or {})
            print(json.dumps({"spans": line}))
            return real_finish(*args, **kwargs)

        instrument.start_profiler = start_profiler
        instrument.read_trace = read_trace
        window.run_isolate = run_isolate
        run_module.finish = finish

    def summarise(self, prof, stage_calls, window_ns) -> dict:
        from autocycler_tpu_torch.obs import trace

        from benchmark.lib import attribute

        spans = trace.close_run(self.run)
        busy, copies = attribute.device_events(prof)
        out = attribute.attribute(spans, stage_calls, busy, copies, window_ns)
        isolates = attribute.per_isolate(spans, stage_calls)
        for iso, gb in zip(isolates, self.to_host):
            iso["to_host_GB"] = gb
        out.update(program_spans=len(spans), isolates=isolates,
                   probe_wait_s=self.probe_wait_s)
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    from benchmark import run
    from benchmark.lib import instrument, window

    run._T_START = _T_START
    ProgramSpans().install(window, instrument, run)
    return run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
