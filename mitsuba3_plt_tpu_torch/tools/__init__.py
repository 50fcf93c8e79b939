"""Tools on the port: the intersection bench (`bench_isect`)."""
