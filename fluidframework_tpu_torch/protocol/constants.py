"""Sentinel sequence numbers and client ids.

Copied from fluidframework_tpu/protocol/constants.py (the values the
port's int32 tables share with the JAX package). Reference:
packages/dds/merge-tree/src/constants.ts:11-15.
"""

# An op/segment that has been applied locally but not yet sequenced by the
# ordering service.
UNASSIGNED_SEQ = -1

# Applies to every perspective: content present "from the beginning".
UNIVERSAL_SEQ = 0

# Internal structural maintenance; never wins a tie-break.
TREE_MAINT_SEQ = -2

# Client id used when not collaborating.
NON_COLLAB_CLIENT = -2

# "No client" marker for int32 tables (removing client slots, etc.).
NO_CLIENT = -3

# Provisional local identity for a rehydrating session.
PROVISIONAL_CLIENT = -4

# Effective-sequence-number encoding used by tie-breaks
# (reference: mergeTree.ts:1719 breakTie).
INT32_MAX = 2**31 - 1
EFF_SEQ_NEW_LOCAL = INT32_MAX
EFF_SEQ_EXISTING_LOCAL = INT32_MAX - 1
