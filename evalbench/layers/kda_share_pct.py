"""The KDA token mixers' share of the eval step's device time, percent:
device time launched inside the program's ``torcheval.kda`` spans (the
projections, convolutions, gates, the scan, the gated norm and the output
projection of every KDA layer) over that inside ``evalbench.step``, in the
steps profiled with the recorder on after the window
(``record["model_spans"]``)."""


def read(record):
    spans = record.get("model_spans")
    if not spans:
        return None
    per = spans["range_device_s"]
    part, step = per.get("torcheval.kda"), per.get("evalbench.step")
    if not part or not step:
        return None
    return 100.0 * part / step
