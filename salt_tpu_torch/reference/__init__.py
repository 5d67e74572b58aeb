"""Plain versions of salt's own algorithms, written for reading and not
for speed, that the port's device code is held to (sa_walk: salt's
sampled suffix array and its locate walks)."""
