"""Latent attention's share of the eval step's device time, percent:
device time launched inside the program's ``torcheval.mla`` spans (every
projection, RoPE and the attention core) over that inside
``evalbench.step``, in the steps profiled with the recorder on after the
window (``record["model_spans"]``)."""


def read(record):
    spans = record.get("model_spans")
    if not spans:
        return None
    per = spans["range_device_s"]
    part, step = per.get("torcheval.mla"), per.get("evalbench.step")
    if not part or not step:
        return None
    return 100.0 * part / step
