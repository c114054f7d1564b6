"""The GB of catalog prints the program copied between host and card in
set-up: the summed bytes of its db.upload (a host array uploaded by
FingerprintDB.device_arrays) and db.host_copy (a device-resident
FingerprintDB's prints copied to the host) spans, over 1e9, from the
process's start to the window's. 0 where set-up made neither."""

from portbench.metrics import _setup

COPIES = ("db.upload", "db.host_copy")


def read(run):
    got = _setup.spans(run)
    if got is None:
        return None
    return sum(s.attrs.get("bytes", 0) for s in got if s.name in COPIES) / 1e9
