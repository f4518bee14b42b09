"""Roofline analysis of the port (``repro/roofline``): the card's rates, a
FLOP counter over aten ops, and the tables of the dry run."""
