"""CELU-VFL core: the round engine, the workset table and instance
weighting (port of ``repro.core``)."""
