"""The traced calls' frames (``Job.pixels`` x channels bytes) over the device
time of the host-to-device copies, as a share of one card's host link, in
%. The link is PCIe Gen5 x16, 64 GB/s a direction (NVIDIA's H100 SXM data
sheet: 128 GB/s both ways); each copy crosses one card's link, so the
summed bytes over the summed copy time is the rate of one link."""

from .h2d_ms_per_image import h2d_s

PCIE_BYTES_PER_S = 64e9


def read(run):
    if run.trace is None or not run.trace.traced_indices or run.bound_jobs is None:
        return None
    seconds = h2d_s(run.trace)
    if seconds <= 0:
        return None
    nbytes = 0
    for k in run.trace.traced_indices:
        job = run.bound_jobs(k)
        nbytes += job.pixels * job.cfg.channels
    return 100.0 * nbytes / seconds / PCIE_BYTES_PER_S
