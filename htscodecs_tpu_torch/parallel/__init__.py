"""Pipelined and multi-device layers: the stream encoder (``streaming``),
the one-call round-trip steps (``pipeline``) and the block-sharded
codecs over several devices and processes (``distributed``)."""
