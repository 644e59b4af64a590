"""Scale-out: process groups, the (dp, sp) mesh and sharded batch encode."""
