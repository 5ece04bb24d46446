"""The traffic runners: one general runner per kind of loop a traffic mix
names (``"loop"`` in ``traffic/<mix>.json``), each a closed loop of one
client over the scene's frames.

* ``fuse``: passes over the F frames, each pass dispatched ahead with no
  host sync inside it and one synchronize at its end.
* ``view``: one colored render_view a request at the next pose of the
  trajectory, each synchronized, the result left on the card.

Set-up fuses ``setup_passes`` passes (a brick volume's first frame
captures the frame graph), then runs the loop itself ``warmup`` times
(passes or requests; the first request captures the render graph). The
warm-up is long on purpose: on the H100 hosts measured (PERF.md), a
process's graph replays ran ~25 % slower for its first 2-45 seconds and
then settled, once, so the window measures the settled speed. The warm-up
is a fixed amount of work, so that set-up is too.

Frame k of a run (set-up included) is the scene's distinct frame
(start + k) mod F, start drawn from the seed: every seed does the same
work, in another order. The view runner keeps a sample of the window's
answers (drawn from the seed) for the comparison with the plain reference,
which runs once the window has closed."""

from __future__ import annotations

import random
import time

import torch

from portbench.system import System


class Stopwatch:
    """A request's latency in ms: CUDA events on the card (the device clock,
    which the host's is not precise enough for at these lengths: the start
    event fires as the request is issued to an idle card, the end event as
    the request's last work ends); the host clock on the CPU, where the
    harness runs only in its tests."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, started) -> float:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            return started.elapsed_time(e)
        return (time.perf_counter() - started) * 1e3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Sample:
    """k answers of the window kept for the check: those whose places among
    its first ``within`` answers were drawn from the seed beforehand. Drawn
    beforehand so that keeping them frees nothing at random times: the
    host's allocator then sees what a user's would, who drops each answer
    for the next."""

    def __init__(self, check: dict, seed: int):
        self.want = set(random.Random(seed).sample(range(int(check["within"])),
                                                   int(check["sample"])))
        self.seen, self.items = 0, []

    def offer(self, item) -> None:
        if self.seen in self.want:
            self.items.append(item)
        self.seen += 1


class Runner:
    def __init__(self, system: System, frames: dict, traffic: dict, seed: int):
        self.system, self.frames, self.traffic, self.seed = system, frames, traffic, seed
        self.F = frames["depths"].shape[0]
        self.device = system.device
        self.n_fused = 0
        self.watch = Stopwatch(self.device)

    def fuse_pass(self) -> None:
        fr = self.frames
        self.system.fuse_pass(fr["depths"], fr["poses"], fr["rgbs"])
        self.n_fused += self.F

    def setup(self) -> None:
        for _ in range(int(self.traffic["setup_passes"])):
            self.fuse_pass()
        sync(self.device)
        self.warmup = self.run(count=int(self.traffic["warmup"]))

    def window(self, seconds: float) -> dict:
        return self.run(seconds=seconds)


class Fuse(Runner):
    def run(self, seconds: float = float("inf"), count: int | None = None) -> dict:
        """Passes until ``seconds`` have passed (the window) or ``count``
        passes are done (the warm-up)."""
        frames0 = self.n_fused
        t0 = last = time.perf_counter()
        passes = []
        while count is None or len(passes) < count:
            self.fuse_pass()
            sync(self.device)
            now = time.perf_counter()
            passes.append((now - last) * 1e3)
            last = now
            if now - t0 >= seconds:
                break
        return dict(seconds=last - t0, frames=self.n_fused - frames0, pass_ms=passes)

    def trace_slice(self) -> dict:
        from torch.profiler import record_function

        passes = int(self.traffic["trace"]["passes"])
        for _ in range(passes):
            with record_function("portbench.fuse"):
                self.fuse_pass()
        return dict(frames=passes * self.F, frame_ids=list(range(self.F)) * passes)


class View(Runner):
    def setup(self) -> None:
        self.n_views = 0
        self.sample = None
        super().setup()
        self.sample = Sample(self.traffic["check"], self.seed)

    def request(self):
        pose = self.frames["poses"][self.n_views % self.F]
        out = self.system.render(pose, self.traffic["render"])
        self.n_views += 1
        return out

    def run(self, seconds: float = float("inf"), count: int | None = None) -> dict:
        lat = []
        t0 = time.perf_counter()
        while (count is None or len(lat) < count) and time.perf_counter() - t0 < seconds:
            pose_id = self.n_views % self.F
            started = self.watch.start()
            out = self.request()
            lat.append(self.watch.stop(started))
            if self.sample is not None:
                self.sample.offer((pose_id, out))
        return dict(seconds=time.perf_counter() - t0, render_ms=lat)

    def trace_slice(self) -> dict:
        from torch.profiler import record_function

        n = int(self.traffic["trace"]["requests"])
        ids = []
        for _ in range(n):
            ids.append(self.n_views % self.F)
            with record_function("portbench.render"):
                self.request()
            sync(self.device)
        return dict(requests=n, pose_ids=ids)


RUNNERS = {"fuse": Fuse, "view": View}
