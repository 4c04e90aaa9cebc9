with gl as (
    select l_orderkey, sum(l_quantity) as sum_qty
    from lineitem
    group by l_orderkey
    having sum(l_quantity) > 300 /*+ shrink(16384) */
)
select l_orderkey, sum_qty, o_custkey, o_orderdate, o_totalprice
from gl
    join orders on l_orderkey = o_orderkey
    join customer on o_custkey = c_custkey
order by o_totalprice desc, o_orderdate
limit 100
