"""The LM stack for serving: modules, attention (over the flash kernel),
the decoder-only transformer and the model facade (a port of
``repro.models`` for dense decoders)."""
