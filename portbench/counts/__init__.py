"""Operations and bytes of the work each learner family's inputs need,
one file a family: ``write(cfg, live, active)`` for one write block with
``live`` unmasked ticks over ``active`` tenants, ``read(cfg, rows)`` for a
read of ``rows`` (tenant, query) rows; each returns ``(ops, bytes)``.

The work counted is that of the inputs, whatever implements it: a masked
tick and a tenant with no live tick in a block count nothing, and every
input byte is read once and every output byte written once. A
multiply-add is two operations, a cosine one."""
