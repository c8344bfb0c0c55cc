"""scan_roofline.prefill: the bytes the Mamba scans of the traced
window's calls need (``harness.counts.scan_bytes``, one call a Mamba
layer) over the HBM bandwidth, over the device time of the
``selective_scan`` kernel, in percent."""

from harness import counts


def read(view):
    if (view.trace is None or view.loop != "prefill" or not view.calls
            or view.spec.mamba is None):
        return None
    s = view.trace.seconds_by_group().get("selective_scan")
    if not s:
        return None
    n = sum(mx == "mamba" for mx, _ in view.spec.kinds)
    need = sum(n * counts.scan_bytes(view.spec, B, S) for B, S in view.calls)
    return 100.0 * need / counts.HBM_BYTES_S / s
