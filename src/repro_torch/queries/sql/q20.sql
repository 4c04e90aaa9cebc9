with fp as (
    select p_partkey from part where p_name like 'forest%'
),
g as (
    select l_partkey, l_suppkey, sum(l_quantity) as sq
    from lineitem
    where l_shipdate >= date '1994-01-01'
      and l_shipdate < date '1995-01-01'
      and l_partkey in (select p_partkey from fp)
    group by l_partkey, l_suppkey
)
select s_suppkey, s_nationkey
from supplier
where s_suppkey in (select ps_suppkey
                    from partsupp
                        join g on ps_partkey = l_partkey
                              and ps_suppkey = l_suppkey
                    where ps_partkey in (select p_partkey from fp)
                      and ps_availqty > 0.5 * sq)
  and s_nationkey = code('n_name', 'CANADA') /*+ shrink(65536) */
order by s_suppkey
