"""PHOLD: the model (:mod:`.model`) and its stack allocator (:mod:`.arena`)."""
