"""Example-buffer growth copies a pass: the program's growth counter
(``torcheval_tpu_torch.metrics._buffer.GROWTHS``) over whole passes,
over the passes (``record["buffer_growths"]``). A counted 0 is a real 0;
a program without the counter reads None."""


def read(record):
    counted = (record or {}).get("buffer_growths")
    if not counted or not counted["passes"]:
        return None
    return counted["growths"] / counted["passes"]
