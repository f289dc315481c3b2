"""The share of the window's tree leaves that the NUTS leaf kernel ran
(``stats["leaf_kernel_leaves"]``) over all of them (the value-and-grad
calls of the ``leaf`` site, ``stats["vag_calls"]["leaf"]``), over the
window's fits. A program without the counter has nothing to read."""


def read(run):
    fits = [f for f in run.fits if "leaf_kernel_leaves" in f.stats and "vag_calls" in f.stats]
    leaves = sum(f.stats["vag_calls"]["leaf"] for f in fits)
    if not leaves:
        return None
    return 100.0 * sum(f.stats["leaf_kernel_leaves"] for f in fits) / leaves
