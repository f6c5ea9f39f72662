"""The device's peak of memory allocated by torch inside ``compress``, the
largest over the window's isolates, in units of 1e9 bytes (the allocator's
peak, reset as each stage call begins)."""


def read(record):
    peaks = [r["stage_peaks"]["compress"] for r in record["isolates"]
             if r["stage_peaks"].get("compress")]
    return max(peaks) / 1e9 if peaks else None
