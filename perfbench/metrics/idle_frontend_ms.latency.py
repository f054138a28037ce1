"""Device-idle ms a recording while the host does the front end's own work
(``OverlapAddSeparator``): chunking, the upload of each batch, stitching
and alignment, and ``separate``'s and each batch's own time, read from the
program's spans. None where the program records no span."""

from perfbench import spans

FRONT_END = ("overlap_add.separate", "overlap_add.chunk", "overlap_add.batch",
             "overlap_add.upload", "overlap_add.stitch", "overlap_add.align")


def read(tr):
    return spans.idle_ms_per_root(tr, lambda name: name in FRONT_END)
