with late as (
    select l_orderkey, l_suppkey
    from lineitem
    where l_receiptdate > l_commitdate
),
g_all as (
    select l_orderkey as ok_all, count(distinct l_suppkey) as nsupp
    from lineitem
    group by l_orderkey
),
g_late as (
    select l_orderkey as ok_late, count(distinct l_suppkey) as nlate
    from late
    group by l_orderkey
)
select l_suppkey, count(*) as numwait
from late
    join g_all on l_orderkey = ok_all
    join g_late on l_orderkey = ok_late
where l_suppkey in (select s_suppkey from supplier
                    where s_nationkey = code('n_name', 'SAUDI ARABIA'))
  and l_orderkey in (select o_orderkey from orders where o_orderstatus = 'F')
  and nsupp >= 2 and nlate = 1
group by l_suppkey
order by numwait desc, l_suppkey
limit 100
