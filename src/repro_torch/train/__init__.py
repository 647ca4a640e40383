"""Training: AdamW, the train and eval steps, the checkpoint and the int8
gradient sync with error feedback (a port of ``repro.train``)."""
