"""Recovery: seeded fault injection (``chaos``), the policy-driven query
runner (``fault``), checkpoints (``checkpoint``) and exchange-boundary
lineage snapshots (``lineage``)."""
