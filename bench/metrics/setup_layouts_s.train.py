"""setup_layouts_s.train: host seconds of set-up (process start to the
window) in the port's graph layouts: the CSR transposes it built
(autosage_transpose_ms, sparse/csr.py) and the layouts its variants
prepared (autosage_prepare_ms, core/registry.py), read from the port's
histograms as the window opened. None where the port keeps no
transpose histogram. Moves setup_s."""

NAMES = ("autosage_transpose_ms", "autosage_prepare_ms")


def read(r):
    before = r.window.hists_before
    if not before.get(NAMES[0]):
        return None
    return sum(total for name in NAMES for _, total in before.get(name, {}).values()) / 1e3
