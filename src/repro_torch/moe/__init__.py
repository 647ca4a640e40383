"""Mixture-of-experts: the expert-parallel layer over stacked EP shards
(:mod:`repro_torch.moe.layer`) and KIP expert placement
(:mod:`repro_torch.moe.kip_placement`), a port of ``repro.moe``."""
