"""Model families: physical problems set up on the stencil core."""
