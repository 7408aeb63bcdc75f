"""spmm_flickr_roofline: ``spmm_roofline`` in the cells that report
``requests_per_s.flickr`` (a share of a roofline keeps ``_roofline`` at
the end of its name): the same reading."""
from hgcn_bench.spec import load_reader

read = load_reader("spmm_roofline")
