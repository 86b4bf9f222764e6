"""The routed experts' share of the eval step's device time, percent:
device time launched inside the program's ``torcheval.moe.experts`` spans
(the grouped products) over that inside ``evalbench.step``, in the steps
profiled with the recorder on after the window
(``record["model_spans"]``)."""


def read(record):
    spans = record.get("model_spans")
    if not spans:
        return None
    per = spans["range_device_s"]
    part, step = per.get("torcheval.moe.experts"), per.get("evalbench.step")
    if not part or not step:
        return None
    return 100.0 * part / step
