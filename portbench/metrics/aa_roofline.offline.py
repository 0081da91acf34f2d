"""aa_roofline.offline: the anti-aliased activations' least time
(``aa_counts.aa_bound_s`` of the elements the program's
``vocoder.aa_elements`` counter added over the stretch that records the
ranges) over the device time launched inside that stretch's ``aa`` ranges,
in %."""

from portbench.aa_counts import aa_bound_s


def read(rec):
    prof = rec.get("ranges") or {}
    device_s = prof.get("label_device_s", {}).get("aa", 0.0)
    elements = rec.get("aa_elements")
    if rec["family"] != "offline" or device_s <= 0 or not elements:
        return None
    return 100.0 * aa_bound_s(elements, rec["conf"]["activations"])[0] / device_s
