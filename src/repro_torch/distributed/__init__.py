"""Distribution: sharding rules, meshes of ranks and placements
(:mod:`.sharding`), differentiable collectives (:mod:`.collectives`), the
band-sharded Jacobi sweep (:mod:`.sharding`) and a launcher of ranks
(:mod:`.ranks`)."""
