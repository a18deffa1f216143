"""apply_k.enqueue_us: host microseconds per element product of K on the
unstructured route: the program's `apply_k.element` spans (no
synchronize in or around them) summed over the window, over their
number. Near apply_k.element_us the product is bound by the host's
launches; far above it, by the device."""
import program_trace as pt

SPANS = pt.labels("apply_k.element")


def prepare(program, profile):
    return pt.start()


def read(rec):
    spans = [r.seconds for r in pt.window(
        rec, rec.prepared.get("apply_k.enqueue_us"))
        if r.name == "apply_k.element"]
    return 1e6 * sum(spans) / len(spans) if spans else None
