with g as (
    select l_suppkey, sum(l_extendedprice * (1 - l_discount)) as total_revenue
    from lineitem
    where l_shipdate >= date '1996-01-01'
      and l_shipdate < date '1996-04-01'
    group by l_suppkey
)
select l_suppkey, total_revenue, s_nationkey
from g
    join supplier on l_suppkey = s_suppkey
where total_revenue >= (select max(total_revenue) from g)
                       * (1 - 0.000000000001) /*+ shrink(1024) */
order by l_suppkey
