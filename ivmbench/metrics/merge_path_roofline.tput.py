"""The merge-path kernel's share of its roofline over the window: the
least time at the card's HBM peak for the bytes each launch's inputs
need (``peaks.merge_bytes``: the valid rows of both runs read once, the
merged rows written once), summed over the window's launches, over the
kernel's time in the device trace for those launches.

In a traced run, ``Probe`` wraps the program's public
``ops/merge_kernel.merge_path`` and keeps each launch's count tensors
without a read (a read would wait for the card); they are read once
after the window."""

from ivmbench import peaks

KERNEL = "merge_path_kernel"  # the name the trace gives the kernel


class Probe:
    def __init__(self):
        from materialize_tpu_torch.ops import merge_kernel

        self.mod = merge_kernel
        self.orig = merge_kernel.merge_path
        self.launches: list = []

    def install(self) -> None:
        orig, launches = self.orig, self.launches

        def merge_path(a_lanes, a_count, cap_a, b_lanes, b_count, out_capacity,
                       want_pos=False):
            if out_capacity > 0:
                launches.append((a_count, b_count, out_capacity, a_lanes.shape[1]))
            return orig(a_lanes, a_count, cap_a, b_lanes, b_count, out_capacity, want_pos)

        self.mod.merge_path = merge_path

    def uninstall(self) -> None:
        self.mod.merge_path = self.orig

    def collect(self, torch, run) -> None:
        """Each launch's (a_count, b_count, out_capacity, lanes) and, when
        the trace holds every launch, each one's device seconds."""
        merges = []
        if self.launches:
            ab = torch.stack([torch.stack([a.reshape(()), b.reshape(())])
                              for a, b, _, _ in self.launches]).cpu().numpy()
            merges = [(int(a), int(b), out, lanes)
                      for (a, b), (_, _, out, lanes) in zip(ab, self.launches)]
        kernel = [e - s for name, s, e in run.device_events or () if KERNEL in name]
        run.extra["merges"] = merges
        run.extra["merge_kernel_s"] = kernel[:len(merges)] if len(kernel) >= len(merges) \
            else None
        self.launches.clear()


def read(run):
    merges, seconds = run.extra.get("merges"), run.extra.get("merge_kernel_s")
    if not merges or not seconds:
        return None
    least = sum(peaks.least_seconds(peaks.merge_bytes(*m)) for m in merges)
    return 100.0 * least / sum(seconds)
