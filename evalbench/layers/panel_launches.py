"""Device operations a batch's panel update launches: median over the
spans window's batches of the device operations whose launch lies inside
a ``torcheval.update_collection`` range (matched by correlation id)."""

import statistics


def read(record):
    spans = (record or {}).get("spans")
    batches = [b for b in (spans or {}).get("batches", ()) if b["collections"]]
    return statistics.median(b["launches"] for b in batches) if batches else None
