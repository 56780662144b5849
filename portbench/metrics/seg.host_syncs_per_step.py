"""Reads from the card to the host per segmentation step: the device-to-host copies launched inside the
steps, an exact count (each ``.item()``, ``.tolist()`` or ``.cpu()`` is one), over the steps."""


def read(r):
    if r.trace is None or not r.trace.spans("pb.step"):
        return None
    copies = [op for op in r.trace.ops_in("pb.step") if "DtoH" in op.name or "Device -> " in op.name]
    return len(copies) / len(r.trace.spans("pb.step"))
