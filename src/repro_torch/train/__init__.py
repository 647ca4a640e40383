"""Training: AdamW, the train and eval steps and the checkpoint (a port of
``repro.train``; the int8 gradient sync of ``train/compression.py`` is not
ported yet, ROADMAP.md queue 1 step 8)."""
