"""Dynamic Repartitioning core: hashing, histograms, partitioners, keyed
state, migration planning, the shuffle and the streaming driver."""
