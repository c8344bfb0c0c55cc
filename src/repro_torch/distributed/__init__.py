"""Sharding rules of the port (the rule tables and their resolution
against a mesh's axis sizes; the collectives wait for ROADMAP.md item
1.6)."""
